"""The batched power loops' useful work over the window (%): the member blocks the
real members needed before their own `cond` ended (member_blocks_used) over the
member blocks the loops ran, bucket × blocks (member_blocks_run), from the
generator's group_stats().  None where the program has no group counters."""


def read(context):
    before = context["counters_before"].get("group")
    after = context["counters_after"].get("group")
    if not before or not after:
        return None
    run = after["member_blocks_run"] - before["member_blocks_run"]
    if run <= 0:
        return None
    return 100.0 * (after["member_blocks_used"] - before["member_blocks_used"]) / run
