"""Write the benchmark's frozen traffic: the grammar-tree pool of the search
cell and the textbook preconditioners of the Helmholtz cell.

    python3 portbench/data/make_pools.py

Runs on the CPU in seconds; the benchmark only reads what it wrote.

  * poisson2d_511_trees.txt: depth-4 trees of 2D Poisson at levels 5-9,
    drawn with gen_grow(pset, 2, 16) from random.Random(20260816) in the
    order of the bench protocol (bench.py), so entries 0-15 are its 16
    trees; the further entries continue the same stream (bench.py's warm-up
    tree, gen_grow(pset, 2, 10), is not among them).
  * helmholtz_textbook_V2_1_w0.6.txt, helmholtz_textbook_V2_2_w0.6.txt:
    the ladder script's textbook V(2,1) and V(2,2) at ω 0.6 (coarse-grid
    correction ω 1.0) as grammar strings of Helmholtz at levels 3-7.

The champion files beside them are byte-for-byte copies of
artifacts/poisson2d_champion_r2_tuned.txt and artifacts/helmholtz_r3/.
"""

from __future__ import annotations

import os
import random
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import torch  # noqa: E402

from evostencils_torch.grammar import gp  # noqa: E402
from evostencils_torch.grammar.multigrid import (  # noqa: E402
    generate_primitive_set, textbook_cycle_string)
from evostencils_torch.problems.helmholtz import helmholtz_2d  # noqa: E402
from evostencils_torch.problems.poisson import poisson_2d  # noqa: E402

POOL_SIZE = 48


def primitive_set(problem, depth):
    return generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=depth, maximum_local_system_size=8)


def main() -> int:
    sys.setrecursionlimit(100000)
    pset, _ = primitive_set(poisson_2d(min_level=5, max_level=9, dtype=torch.float32), 4)
    rng = random.Random(20260816)
    trees = [str(gp.gen_grow(pset, 2, 16, rng=rng)) for _ in range(POOL_SIZE)]
    with open(os.path.join(HERE, "poisson2d_511_trees.txt"), "w") as fh:
        fh.write("\n".join(trees) + "\n")

    problem = helmholtz_2d(min_level=3, max_level=7, k=80.0, dtype=torch.complex128)
    _, terminals = primitive_set(problem, 4)
    for pre, post in ((2, 1), (2, 2)):
        text = textbook_cycle_string(terminals, pre, post, omega_index=10)
        with open(os.path.join(HERE, f"helmholtz_textbook_V{pre}_{post}_w0.6.txt"), "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
