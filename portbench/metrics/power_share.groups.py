"""Share of the traced sub-window's `evaluate_group` wall time spent inside the
program's `loop.power_batched` spans (%).  None without a traced run, or where the
program records neither span."""
from portbench.program_spans import recording, union


def read(context):
    spans = recording(context)
    roots = union((s.start_ns, s.end_ns) for s in spans or () if s.name == "evaluate_group")
    loops = union((s.start_ns, s.end_ns) for s in spans or () if s.name == "loop.power_batched")
    total = sum(e - s for s, e in roots)
    if total <= 0 or not loops:
        return None
    inside = sum(max(0, min(e, re) - max(s, rs)) for s, e in loops for rs, re in roots)
    return 100.0 * inside / total
