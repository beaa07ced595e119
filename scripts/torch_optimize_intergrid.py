#!/usr/bin/env python
"""CMA-ES optimization of restriction/prolongation stencil weights with the
PyTorch/CUDA port (the counterpart of scripts/optimize_intergrid.py).

Fitness is the LFA-predicted two-grid convergence factor
(evostencils_torch/models/lfa.py, numpy: thousands of evaluations per
second, no cycle runs in the loop, so no card is needed); the incumbent is
the textbook full-weighting/bilinear pair.

    python3 scripts/torch_optimize_intergrid.py --problem poisson2d --generations 30
"""

import argparse
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from evostencils_torch.optimization.intergrid_transfer import optimize_intergrid_weights
from evostencils_torch.problems import build_named_problem


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--problem", default="poisson2d")
    parser.add_argument("--min-level", type=int, default=4)
    parser.add_argument("--max-level", type=int, default=5)
    parser.add_argument("--radius", type=int, default=1)
    parser.add_argument("--generations", type=int, default=30)
    parser.add_argument("--sigma", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    problem = build_named_problem(args.problem, args.min_level, args.max_level)
    restriction, prolongation, rho, history = optimize_intergrid_weights(
        problem,
        radius=args.radius,
        generations=args.generations,
        sigma=args.sigma,
        seed=args.seed,
        verbose=True,
    )
    print(f"\nBaseline (FW/bilinear) two-grid rho: {history[0]:.4f}")
    print(f"Optimized two-grid rho:              {rho:.4f}")
    print("Restriction stencil:")
    for offset, value in restriction.entries:
        print(f"  {offset}: {value:+.5f}")
    print("Prolongation stencil:")
    for offset, value in prolongation.entries:
        print(f"  {offset}: {value:+.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
