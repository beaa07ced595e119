#!/usr/bin/env python
"""Time the textbook baseline solver with the PyTorch/CUDA port (the
counterpart of scripts/evaluate_reference_solver.py).

Builds the standard V(pre, post) red-black collective-Jacobi cycle over the
whole hierarchy (the analog of ExaStencils' default `generate solver`
configuration) and measures its time to convergence, convergence factor
and iterations through TorchProgramGenerator on the card, the time as the
median over --samples runs.  This is the baseline evolved solvers must
beat.

  python3 scripts/torch_evaluate_reference_solver.py --pre 2 --post 1
  python3 scripts/torch_evaluate_reference_solver.py --cpu --min-level 3 --max-level 5

Without CUDA it stops unless --cpu is given.
"""

import argparse
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.problems import build_named_problem


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--problem", default="poisson2d")
    parser.add_argument("--min-level", type=int, default=5)
    parser.add_argument("--max-level", type=int, default=9)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--pre", type=int, default=2)
    parser.add_argument("--post", type=int, default=1)
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the GPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    return args


def run(argv=None) -> dict:
    """Evaluate the textbook cycle; returns what it printed."""
    args = parse_arguments(argv)
    problem = build_named_problem(args.problem, args.min_level, args.max_level)
    _, terminal_list = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level,
    )
    cycle = generate_v_cycle(
        terminal_list, problem.rhs(), pre_smoothing=args.pre, post_smoothing=args.post)
    generator = TorchProgramGenerator(problem, device="cpu" if args.cpu else "cuda")
    t, rho, iterations = generator.generate_and_evaluate(cycle, evaluation_samples=args.samples)
    print(f"Reference V({args.pre},{args.post}) RB-Jacobi cycle on {problem.name} "
          f"({generator.device.type}):")
    print(f"  Time to convergence: {t:.3f} ms")
    print(f"  Convergence factor:  {rho:.6f}")
    print(f"  Iterations:          {iterations}")
    return {"problem": problem.name, "device": generator.device.type,
            "time_to_convergence_ms": t, "convergence_factor": rho, "iterations": iterations}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
