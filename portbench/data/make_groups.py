"""Write the frozen traffic of the groups cell: same-structure groups of
grammar trees that differ only in their relaxation factors, as the
optimizer's ω mutations and same-structure crossovers breed them.

    python3 portbench/data/make_groups.py

Runs on the CPU in seconds; the benchmark only reads what it wrote.  The
numbers of the draw (group count and sizes, node limit, redraw probability,
omega count, seed) are the configuration's, configs/poisson2d_511_groups.json.

  * poisson2d_511_groups.txt: 12 groups, one line a member, `g<group>.m<member>
    <tree>`.  Group g's base tree is the g-th tree of the search mix's order
    (traffic/search.json) that compiles and has at most 150 nodes, the
    optimizer's limit for grouping (optimization/optimizer.py); groups hold
    16, 8, 16, 8, ... members, 144 in all.  Member 0 is the base tree as it
    is.  In member m > 0 every `rf_<k>` terminal is redrawn with probability
    1/4, uniformly from the grammar's 37 indices, by numpy's default_rng
    seeded with (SEED, g, m, attempt); a draw that repeats an earlier member
    of its group is drawn again with the next attempt.  Every member of a
    group shares the base tree's canonical_string(..., parameterize_relaxation
    =True), and no two members of a group are the same string: both are
    checked, and a failed check raises.
"""

from __future__ import annotations

import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(PORTBENCH))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from evostencils_torch.grammar import gp  # noqa: E402
from evostencils_torch.ir.transformations import canonical_string  # noqa: E402
from evostencils_torch.problems.poisson import poisson_2d  # noqa: E402
from portbench.kinds import common  # noqa: E402

with open(os.path.join(PORTBENCH, "configs", "poisson2d_511_groups.json")) as _fh:
    CONFIG = json.load(_fh)
SEED = CONFIG["group_seed"]
GROUPS = CONFIG["groups"]
SIZES = tuple(CONFIG["group_sizes"])
MAX_NODES = CONFIG["group_node_limit"]
REDRAW = CONFIG["redraw_probability"]
OMEGA_INDICES = CONFIG["relaxation_factors"]["count"]
_OMEGA = re.compile(r"\brf_(\d+)\b")


def draw_member(base: str, group: int, member: int, attempt: int = 0) -> str:
    """`base` with each rf_<k> terminal redrawn with probability 1/4."""
    rng = np.random.default_rng([SEED, group, member, attempt])

    def redraw(match):
        if rng.random() < REDRAW:
            return f"rf_{int(rng.integers(OMEGA_INDICES))}"
        return match.group(0)

    return _OMEGA.sub(redraw, base)


def draw_group(base: str, group: int, size: int) -> list:
    """`size` distinct members: the base tree, then its redrawn variants."""
    members = [base]
    for member in range(1, size):
        attempt = 0
        text = draw_member(base, group, member, attempt)
        while text in members:
            attempt += 1
            text = draw_member(base, group, member, attempt)
        members.append(text)
    return members


def structure(text: str, pset) -> str:
    expression = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
    return canonical_string(expression, parameterize_relaxation=True)


def primitive_set(config: dict):
    problem = poisson_2d(config["min_level"], config["max_level"], dtype=torch.float32)
    return common.primitive_set(problem, config)[0]


def make_groups(pool: list, order: list, pset, groups: int = GROUPS) -> list:
    """[(group, members)] from the first `groups` eligible trees of `order`."""
    out = []
    for index in order:
        if len(out) == groups:
            break
        tree = gp.parse_tree(pool[index], pset)
        if len(tree) > MAX_NODES:
            continue
        try:
            key = structure(pool[index], pset)
        except (MemoryError, RuntimeError):
            continue
        group = len(out)
        members = draw_group(pool[index], group, SIZES[group % len(SIZES)])
        if len(set(members)) != len(members):
            raise ValueError(f"group {group}: members repeat")
        if any(structure(m, pset) != key for m in members):
            raise ValueError(f"group {group}: a member's structure differs")
        out.append((group, members))
    if len(out) != groups:
        raise ValueError("too few eligible trees in the order")
    return out


def lines(groups: list) -> str:
    return "".join(f"g{g}.m{m} {text}\n" for g, members in groups
                   for m, text in enumerate(members))


def main() -> int:
    sys.setrecursionlimit(100000)
    with open(os.path.join(PORTBENCH, "traffic", "search.json")) as fh:
        search = json.load(fh)
    with open(os.path.join(HERE, "poisson2d_511_trees.txt")) as fh:
        pool = [line.strip() for line in fh if line.strip()]
    groups = make_groups(pool, search["order"], primitive_set(CONFIG))
    with open(os.path.join(HERE, f"{CONFIG['name']}.txt"), "w") as fh:
        fh.write(lines(groups))
    return 0


if __name__ == "__main__":
    sys.exit(main())
