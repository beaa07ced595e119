#!/usr/bin/env python
"""Gradient ω-tuning of stored champion artifacts with the PyTorch/CUDA
port (the counterpart of scripts/tune_champions.py; the batch form of
`torch_optimize.py --tune`).

For each artifact: parse the grammar string, tune the relaxation factors
with the differentiable error-propagation surrogate
(optimization/relaxation.tune_relaxation_factors, torch.autograd through a
lowering without kernels, which have no backward), re-measure on the card,
and write `<name>_tuned.txt` with the stored-ω line that champion
consumers parse (utils/champions.py), beside the input or in --output-dir.

  python3 scripts/torch_tune_champions.py artifacts/paper_protocol/individual_0.txt \\
      --output-dir chiprun_out/tuned

Without CUDA it stops unless --cpu is given.
"""

import argparse
import os
import statistics
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.optimization.relaxation import tune_relaxation_factors
from evostencils_torch.problems import build_named_problem
from evostencils_torch.utils.champions import parse_champion_file


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("champions", nargs="+")
    parser.add_argument("--problem", default="poisson2d")
    parser.add_argument("--min-level", type=int, default=5)
    parser.add_argument("--max-level", type=int, default=9)
    parser.add_argument("--max-local-system-size", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--samples", type=int, default=3,
                        help="re-measurement samples before/after tuning "
                             "(median ρ is written to the artifact header)")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the GPU")
    parser.add_argument("--suffix", default="_tuned")
    parser.add_argument("--output-dir", default=None,
                        help="where to write the tuned files (default: beside "
                             "each input)")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    return args


def run(argv=None) -> list:
    """Tune every champion; returns one record per written file."""
    args = parse_arguments(argv)
    problem = build_named_problem(args.problem, args.min_level, args.max_level)
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level,
        maximum_local_system_size=args.max_local_system_size,
        FAS=bool(problem.uses_fas),
    )
    generator = TorchProgramGenerator(problem, device="cpu" if args.cpu else "cuda")
    lowering = CycleLowering(problem.dtype, generator.device, use_kernels=False)

    def _measure(expr):
        """Median (ρ, iterations) over --samples seeded-RHS measurements
        (a distinct rhs_seed per sample, as scripts/torch_champion_stats.py)."""
        rhos, its = [], []
        for s in range(max(1, args.samples)):
            generator.rhs_seed = 1000 + s
            _, rho, it = generator.generate_and_evaluate(expr, evaluation_samples=1)
            rhos.append(float(rho))
            its.append(it)
        generator.rhs_seed = None
        return statistics.median(rhos), sorted(its)[len(its) // 2]

    records = []
    for path in args.champions:
        tree_str, _ = parse_champion_file(path)
        expr, _ = gp.compile_tree(gp.parse_tree(tree_str, pset), pset)
        rho0, it0 = _measure(expr)
        tuned, _ = tune_relaxation_factors(
            expr, generator.problem, lowering=lowering, iterations=args.iterations)
        rho1, it1 = _measure(expr)
        out = os.path.splitext(path)[0] + args.suffix + ".txt"
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            out = os.path.join(args.output_dir, os.path.basename(out))
        with open(out, "w") as fh:
            fh.write(tree_str + "\n")
            fh.write(f"# tuned omegas: {[round(w, 4) for w in tuned]}\n")
            fh.write(f"# rho (median of {args.samples}): {rho0} -> {rho1}; "
                     f"iters {it0} -> {it1}\n")
        print(f"{path}: rho {rho0:.4f} -> {rho1:.4f}, iters {it0} -> {it1} "
              f"-> {out}", flush=True)
        records.append({"file": path, "output": out, "rho_before": rho0, "rho_after": rho1,
                        "iterations_before": it0, "iterations_after": it1,
                        "omegas": [float(w) for w in tuned]})
    return records


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
