"""The largest rank's ns evaluating its share over the mean of all ranks,
from every rank's dispatch.counters (local_ns), the change over the window;
1.0 is balanced.  None where the program has no dispatch counters."""


def read(context):
    before = context["counters_before"].get("dispatch")
    after = context["counters_after"].get("dispatch")
    if not before or not after:
        return None
    local = [a["local_ns"] - b["local_ns"] for a, b in zip(after, before)]
    mean = sum(local) / len(local)
    return max(local) / mean if mean > 0 else None
