#!/usr/bin/env python
"""Re-evaluate a stored evolved solver with the PyTorch/CUDA port (the
counterpart of scripts/evaluate_evolved_solver.py).

Loads a grammar-string individual (the first line of an
individual_<j>.txt that scripts/torch_optimize.py or scripts/optimize.py
wrote), re-parses it through the typed grammar and measures time to
convergence, convergence factor and iterations on the card with 20
evaluation samples.  Stored tuned ω are not applied (see
scripts/torch_champion_stats.py for that).

  python3 scripts/torch_evaluate_evolved_solver.py artifacts/exafile_poisson_champion_r5.txt
  python3 scripts/torch_evaluate_evolved_solver.py --cpu --min-level 3 --max-level 5 \\
      results/individual_0.txt

Without CUDA it stops unless --cpu is given.
"""

import argparse
import os
import random
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.problems import build_named_problem


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("individual", help="path to individual_<j>.txt")
    parser.add_argument("--problem", default="poisson2d")
    parser.add_argument("--min-level", type=int, default=5)
    parser.add_argument("--max-level", type=int, default=9)
    parser.add_argument("--evaluation-samples", type=int, default=20)
    parser.add_argument("--max-local-system-size", type=int, default=8)
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the GPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    return args


def run(argv=None) -> dict:
    """Evaluate the stored individual; returns what it printed."""
    args = parse_arguments(argv)
    with open(args.individual) as f:
        grammar_string = f.readline().strip()
    problem = build_named_problem(args.problem, args.min_level, args.max_level)
    generator = TorchProgramGenerator(problem, device="cpu" if args.cpu else "cuda")
    optimizer = Optimizer.for_problem(problem, program_generator=generator,
                                      rng=random.Random(0))
    t, rho, iterations = optimizer.generate_and_evaluate_program_from_grammar_representation(
        grammar_string, args.max_local_system_size,
        evaluation_samples=args.evaluation_samples,
    )
    print(f"Device:              {generator.device.type}")
    print(f"Time to convergence: {t:.3f} ms")
    print(f"Convergence factor:  {rho:.6f}")
    print(f"Iterations:          {iterations}")
    return {"individual": args.individual, "device": generator.device.type,
            "time_to_convergence_ms": t, "convergence_factor": rho, "iterations": iterations}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
