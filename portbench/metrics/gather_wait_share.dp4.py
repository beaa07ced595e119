"""Share of the ranks' dispatch time spent gathering (%): every rank's
dispatch.counters gather ns over its local and gather ns, summed over the
ranks, the change over the window.  A rank's gather holds its wait for the
slowest rank and the all_gather itself.  Summed over the ranks, it does not
depend on which of the mix's fixed shares the seed gives rank 0.  None where
the program has no dispatch counters."""


def read(context):
    before = context["counters_before"].get("dispatch")
    after = context["counters_after"].get("dispatch")
    if not before or not after:
        return None
    local = sum(a["local_ns"] - b["local_ns"] for a, b in zip(after, before))
    gather = sum(a["gather_ns"] - b["gather_ns"] for a, b in zip(after, before))
    if local + gather <= 0:
        return None
    return 100.0 * gather / (local + gather)
