"""Share of the member evaluations the window handed to the program whose power
iterations ran in a batched loop (%): the change of the generator's batched_members
(group_stats()) over the members of the groups the window evaluated, the last group,
which the window's end cuts, counted whole.  None where the program has no group
counters."""


def read(context):
    before = context["counters_before"].get("group")
    after = context["counters_after"].get("group")
    if not before or not after:
        return None
    members = context["counters_after"]["members_evaluated"] - context["counters_before"][
        "members_evaluated"]
    if members <= 0:
        return None
    return 100.0 * (after["batched_members"] - before["batched_members"]) / members
