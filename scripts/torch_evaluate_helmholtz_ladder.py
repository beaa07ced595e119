#!/usr/bin/env python
"""Evaluate Helmholtz preconditioner cycles at the k-ladder with the
PyTorch/CUDA port (the counterpart of scripts/evaluate_helmholtz_ladder.py).

For each candidate cycle, runs the full protocol: the cycle preconditions
BiCGStab on the outer Helmholtz operator A at k = 80, 160, 320 over a fixed
level range, to the true 1e-7 relative target (restarts from the exact
host residual), and reports outer iterations and ρ_outer per k.

Candidates: the textbook V(2,1)/V(2,2) shifted-Laplace cycles at ω = 0.6
and, optionally, evolved grammar strings (--champion FILE, repeatable).

    python3 scripts/torch_evaluate_helmholtz_ladder.py --dtype complex128 \\
        --champion artifacts/helmholtz_k320_r5/individual_0.txt

Runs on the GPU; without CUDA it stops unless --cpu is given.
"""

import argparse
import os
import sys
import time
from typing import NamedTuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set, textbook_cycle_string
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.optimization.relaxation import tune_outer_relaxation
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.utils.champions import (
    apply_stored_omegas, omega_index, parse_champion_file,
)


class Rung(NamedTuple):
    """One candidate at one k."""

    k: float
    converged: bool
    time_ms: float
    rho: float
    iterations: float
    # Wall time of the whole evaluation (probe, stages, timing sample), and
    # what the probe and the stages did (generator.last_outer_solve).
    wall_s: float
    outer: dict


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--min-level", type=int, default=3)
    parser.add_argument("--max-level", type=int, default=7)
    parser.add_argument("--k", type=float, default=80.0)
    parser.add_argument("--champion", action="append", default=[])
    parser.add_argument("--max-iterations", type=int, default=10000)
    parser.add_argument("--rungs", type=int, default=3,
                        help="number of k-ladder rungs (k·2^i) to evaluate; "
                             "1 = base k only, for fast sweeps")
    parser.add_argument("--textbook", action="append", default=[],
                        metavar="PRE,POST,OMEGA",
                        help="extra textbook V(PRE,POST) ω=OMEGA candidates "
                             "(repeatable); the default set is V(2,1)/V(2,2) "
                             "at ω=0.6")
    parser.add_argument("--tune-outer", type=int, default=0, metavar="GENS",
                        help="CMA-ES-tune each candidate's relaxation factors "
                             "against the measured outer iteration count at "
                             "the base k for GENS generations before the "
                             "ladder sweep")
    parser.add_argument("--save-tuned", default=None, metavar="DIR",
                        help="write tuned candidates as grammar+ω artifacts "
                             "into DIR")
    parser.add_argument("--no-default-textbooks", action="store_true",
                        help="skip the built-in V(2,1)/V(2,2) baselines")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the GPU")
    parser.add_argument("--dtype", default="complex64",
                        choices=["complex64", "complex128"],
                        help="complex128 runs one continuous double-precision "
                             "BiCGStab solve, without the restart stages of "
                             "complex64")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    return args


def build_candidates(args, problem):
    """[(name, expression)] and the reloadable grammar string per name."""
    pset, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=args.max_level - args.min_level,
        maximum_local_system_size=8,
    )
    textbook_specs = [] if args.no_default_textbooks else [(2, 1, 0.6), (2, 2, 0.6)]
    for spec_str in args.textbook:
        parts = spec_str.split(",")
        spec = (int(parts[0]), int(parts[1]), float(parts[2]))
        if spec not in textbook_specs:
            textbook_specs.append(spec)
    candidates = []
    grammar_strings = {}
    for pre, post, omega in textbook_specs:
        name = f"textbook V({pre},{post}) ω={omega}"
        candidates.append((name, generate_v_cycle(
            terminals, problem.rhs(), pre_smoothing=pre, post_smoothing=post, omega=omega)))
        grammar_strings[name] = textbook_cycle_string(
            terminals, pre, post, omega_index=omega_index(omega))
    for path in args.champion:
        tree_string, omegas = parse_champion_file(path)
        try:
            expr, _ = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)
        except Exception as e:  # a string of another grammar: say so, go on
            print(f"[skip] {path}: {type(e).__name__}: {e}", flush=True)
            continue
        name = path.rsplit("/", 1)[-1].replace(".txt", "")
        grammar_strings[name] = tree_string
        if apply_stored_omegas(expr, omegas, label=path):
            name += " (tuned ω)"
        candidates.append((name, expr))
    return candidates, grammar_strings


def tune(args, generator, candidates, grammar_strings):
    for name, expr in candidates:
        tuned, best = tune_outer_relaxation(
            expr, generator, iterations=args.tune_outer, verbose=True)
        print(f"[tuned {name}] outer fitness -> {best:.1f} "
              f"ω={[round(w, 3) for w in tuned]}", flush=True)
        if not args.save_tuned:
            continue
        os.makedirs(args.save_tuned, exist_ok=True)
        safe = name.replace(" ", "_").replace("(", "").replace(")", "").replace(
            ",", "_").replace("ω=", "w")
        # The reloadable form: the grammar string and the tuned ω vector,
        # applied at load time through the `# tuned omegas:` comment.
        durable = grammar_strings.get(name) or grammar_strings.get(
            name.replace(" (tuned ω)", ""))
        with open(os.path.join(args.save_tuned, f"{safe}_tuned.txt"), "w") as f:
            f.write(durable + "\n")
            f.write(f"# tuned omegas: {[round(w, 4) for w in tuned]}\n")
            f.write(f"# outer fitness at k={args.k}: {best}\n")


def evaluate_ladder(generator, name, expr, k0: float, rungs: int) -> list:
    """The candidate at k0·2^i for each rung; the base k is restored."""
    per_k = []
    for step in range(rungs):
        k = k0 * 2 ** step
        generator._apply_parameter_values({"k": k})
        start = time.perf_counter()
        t, rho, iterations = generator.generate_and_evaluate(expr, evaluation_samples=1)
        rung = Rung(k, t < 1e50, t, rho, iterations, time.perf_counter() - start,
                    dict(generator.last_outer_solve))
        per_k.append(rung)
        print(f"[{name}] k={k:.0f}: "
              f"{'converged' if rung.converged else 'FAILED'} "
              f"rho_outer={min(rho, 9.99):.4f} "
              f"outer_iters={min(iterations, 99999):.0f} "
              f"t={min(t, 9e9):.1f}ms", flush=True)
    generator._apply_parameter_values({"k": k0})
    return per_k


def run(argv=None):
    """Parse `argv`, tune if asked, sweep the ladder and print the table;
    returns (generator, [(name, [Rung, ...])])."""
    args = parse_arguments(argv)
    sys.setrecursionlimit(100000)
    problem = helmholtz_2d(min_level=args.min_level, max_level=args.max_level, k=args.k)
    if args.max_iterations:
        problem = problem._clone(
            outer_solver=dict(problem.outer_solver, max_iterations=args.max_iterations))
    candidates, grammar_strings = build_candidates(args, problem)
    generator = TorchProgramGenerator(
        problem, dtype=getattr(torch, args.dtype), device="cpu" if args.cpu else "cuda")
    print(f"# Helmholtz ladder k={args.k}·(1,2,4), levels "
          f"[{args.min_level},{args.max_level}], outer target 1e-7, "
          f"cap {args.max_iterations}, {args.dtype} on {generator.device}\n", flush=True)
    if args.tune_outer:
        tune(args, generator, candidates, grammar_strings)

    rows = [(name, evaluate_ladder(generator, name, expr, args.k, args.rungs))
            for name, expr in candidates]
    print("\n| preconditioner cycle | k | outcome | outer iters | ρ_outer |")
    print("|---|---|---|---|---|")
    for name, per_k in rows:
        for rung in per_k:
            print(f"| {name} | {rung.k:.0f} | "
                  f"{'converged to 1e-7' if rung.converged else 'cap/diverged'} | "
                  f"{min(rung.iterations, 99999):.0f} | {min(rung.rho, 9.99):.4f} |")
    return generator, rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
