#!/usr/bin/env python
"""N-sample re-measurement of stored champion artifacts with the
PyTorch/CUDA port (the counterpart of scripts/champion_stats.py).

For each champion artifact this script

  * parses the grammar string and the stored tuned relaxation factors
    (utils/champions.py format),
  * evaluates ``--samples`` independent measurements through
    TorchProgramGenerator on the card; each sample uses a distinct seeded
    random right-hand side (the generator's ``rhs_seed``), so the spread of
    the measured convergence factor reflects initial-error content and the
    spread of the timing reflects machine noise,
  * reports min/median/max for measured ρ, time to target and iteration
    count, with and without the stored tuned ω, in the JSON layout of
    scripts/champion_stats.py (plus the device's name).

With it the card's medians compare with the stored n = 20 records
(artifacts/*stats_n20*.json), which scripts/champion_stats.py wrote:

  python3 scripts/torch_champion_stats.py \\
      artifacts/paper_protocol/individual_0_tuned.txt --samples 20 \\
      --json chiprun_out/poisson2d_stats_n20_cuda.json

Without CUDA it stops unless --cpu is given.
"""

import argparse
import json
import os
import statistics
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.problems import build_named_problem
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file

# Each family's published champion configuration (scripts/champion_stats.py).
DEFAULT_LEVELS = {
    "poisson2d": (5, 9), "poisson2d_var": (5, 9), "poisson3d": (2, 6),
    "elasticity": (5, 8), "helmholtz": (3, 7), "fas": (5, 9),
}


def _stats(values):
    finite = [v for v in values if v < 1e50]
    if not finite:
        return {"n": 0, "all_failed": True}
    return {
        "n": len(finite),
        "min": min(finite),
        "median": statistics.median(finite),
        "max": max(finite),
        "failed": len(values) - len(finite),
    }


def measure(generator, expr, samples, base_seed=1000, vary="rhs"):
    """Per-sample (time_ms, rho, iterations) lists over seeded samples.

    ``vary="rhs"`` seeds a random right-hand side per sample (the default
    spread protocol); ``vary="init"`` seeds a random initial guess and
    keeps the physical right-hand side (the protocol that still converges
    on indefinite problems, Helmholtz k ≥ 160); ``vary="none"`` repeats the
    identical fixed-RHS zero-guess solve (timing noise only)."""
    times, rhos, its = [], [], []
    attr = {"init": "init_seed", "rhs": "rhs_seed", "none": None}[vary]
    for s in range(samples):
        if attr is not None:
            setattr(generator, attr, base_seed + s)
        t, rho, n = generator.generate_and_evaluate(expr, evaluation_samples=1)
        times.append(float(t))
        rhos.append(float(rho))
        its.append(int(n) if n < 1e18 else n)
    if attr is not None:
        setattr(generator, attr, None)
    return times, rhos, its


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("champions", nargs="+",
                        help="champion artifact files (grammar string + "
                             "optional '# tuned omegas: [...]' line)")
    parser.add_argument("--problem", default="poisson2d", choices=sorted(DEFAULT_LEVELS))
    parser.add_argument("--min-level", type=int, default=None)
    parser.add_argument("--max-level", type=int, default=None)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--max-local-system-size", type=int, default=8)
    parser.add_argument("--helmholtz-k0", type=float, default=None,
                        help="wavenumber for --problem helmholtz (default 80)")
    parser.add_argument("--outer-cap", type=int, default=None,
                        help="outer-solver iteration cap override")
    parser.add_argument("--vary", choices=("rhs", "init", "none"), default="rhs",
                        help="per-sample randomization: 'rhs' = seeded random "
                             "right-hand side (default); 'init' = seeded random "
                             "initial guess with the physical right-hand side; "
                             "'none' = the identical fixed-RHS solve")
    parser.add_argument("--tuned-only", action="store_true",
                        help="measure only the stored-tuned-ω row of each artifact")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the GPU")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "float64", "complex64", "complex128"])
    parser.add_argument("--json", default=None, help="also write a JSON report")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    return args


def run(argv=None) -> dict:
    """Measure every champion; returns the report."""
    args = parse_arguments(argv)
    default_levels = DEFAULT_LEVELS[args.problem]
    if args.min_level is None:
        args.min_level = default_levels[0]
    if args.max_level is None:
        args.max_level = default_levels[1]
    if args.problem == "helmholtz" and args.helmholtz_k0 is not None:
        problem = helmholtz_2d(min_level=args.min_level, max_level=args.max_level,
                               k=args.helmholtz_k0)
    else:
        problem = build_named_problem(args.problem, args.min_level, args.max_level)
    if args.outer_cap and problem.outer_solver:
        problem = problem._clone(
            outer_solver=dict(problem.outer_solver, max_iterations=args.outer_cap))
    if args.dtype:
        problem = problem._clone(dtype=getattr(torch, args.dtype))
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level,
        maximum_local_system_size=args.max_local_system_size,
        FAS=bool(problem.uses_fas),
    )
    generator = TorchProgramGenerator(problem, device="cpu" if args.cpu else "cuda")

    report = {"problem": args.problem,
              "levels": [args.min_level, args.max_level],
              "helmholtz_k0": args.helmholtz_k0,
              "outer_cap": args.outer_cap,
              "vary": args.vary,
              "samples": args.samples,
              "platform": generator.device.type,
              "device": (torch.cuda.get_device_name(generator.device)
                         if generator.device.type == "cuda" else "cpu"),
              "champions": []}
    for path in args.champions:
        tree_str, omegas = parse_champion_file(path)
        entry = {"file": path, "has_stored_omegas": omegas is not None}
        for label, use_omegas in (("untuned", False), ("tuned", True)):
            if use_omegas and omegas is None:
                continue
            if args.tuned_only and not use_omegas and omegas is not None:
                continue
            expr, _ = gp.compile_tree(gp.parse_tree(tree_str, pset), pset)
            if use_omegas and not apply_stored_omegas(expr, omegas, label=path):
                continue
            times, rhos, its = measure(generator, expr, args.samples, vary=args.vary)
            entry[label] = {
                "rho": _stats(rhos),
                "time_to_target_ms": _stats(times),
                "iterations": _stats([float(i) for i in its]),
            }
            r = entry[label]["rho"]
            t = entry[label]["time_to_target_ms"]
            print(f"{path} [{label}] n={args.samples}: "
                  f"rho min/med/max = {r.get('min', float('nan')):.4f}/"
                  f"{r.get('median', float('nan')):.4f}/"
                  f"{r.get('max', float('nan')):.4f}; "
                  f"time-to-target med {t.get('median', float('nan')):.1f} ms",
                  flush=True)
        report["champions"].append(entry)

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"report written to {args.json}")
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
