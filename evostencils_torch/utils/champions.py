"""Champion artifact I/O shared by the entry scripts.

A champion artifact is a text file whose first non-comment line is the
individual's grammar string, optionally followed by

    # tuned omegas: [0.82, 1.1, ...]

holding relaxation factors in `collect_cycles` order (the order
`tune_relaxation_factors` / `tune_outer_relaxation` report them).
headline_1024.py, evaluate_helmholtz_ladder.py and optimize.py all
consume this format; keeping the parsing and the stored-ω application in
one place prevents the scripts from diverging (a silent mismatch path in
one of them once produced wrong headline numerics).
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple


def parse_champion_file(path: str) -> Tuple[Optional[str], Optional[List[float]]]:
    """(grammar_string, stored_omegas_or_None) from a champion artifact."""
    tree_string = None
    omegas = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("# tuned omegas:"):
                omegas = json.loads(line.split(":", 1)[1])
            elif not line.startswith("#") and tree_string is None:
                tree_string = line
    return tree_string, omegas


def apply_stored_omegas(expression, omegas, label: str = "champion") -> bool:
    """Write stored ω into the expression's Cycle nodes (collect_cycles
    order).  Returns False — leaving the grammar string's own factors in
    place — when the count does not match the expression's cycles at this
    level configuration; NEVER feed a mismatched vector to a lowering
    (static jit indexing silently clamps out-of-bounds ω indices)."""
    from evostencils_torch.ir.transformations import collect_cycles

    if omegas is None:
        return False
    cycles = collect_cycles(expression)
    if len(cycles) != len(omegas):
        print(f"[warn] {label}: stored {len(omegas)} omegas but the "
              f"expression has {len(cycles)} cycles at this level config — "
              f"keeping the grammar string's own relaxation factors",
              flush=True)
        return False
    for c, w in zip(cycles, omegas):
        c.relaxation_factor = float(w)
    return True


def omega_index(omega: float) -> int:
    """Nearest grammar relaxation-factor index (37 samples over
    [0.1, 1.9], the reference's search space)."""
    return max(0, min(36, round((omega - 0.1) / 0.05)))
