#!/usr/bin/env python
"""Headline benchmark on the PyTorch/CUDA port: 2D Poisson 1023² time to a
1e-10 relative residual (the counterpart of scripts/headline_1024.py).

Textbook V(2,1) and V(2,2) cycles and evolved champions solve the 1023²
problem in staged restarts (evostencils_torch/backend/device_solve.py):
float32 cycles on the card (the red-black sweep through the hand-written
kernel, csrc/rb_sweep.cu, on every level from 63² to 1023²), float64
restart residuals on the card, the verdict from the exact host IEEE-f64
residual.

Reported per solver:
  * ρ: the power iteration of TorchProgramGenerator (float32);
  * cycles, stages and the true-f64 relative residual (must be ≤ target);
  * the measured f32 stage floor (--predicted);
  * wall time of the whole solve, min and median over --repeats: on the
    card the solver's bodies and cycle replay CUDA graphs captured once per
    solver (backend/device_solve.py), so this is what a user of the solver
    waits for, the host's control and its float64 verdict included; the
    captures, their seconds and the bytes the solver's graphs hold;
  * with --compare-eager, the same solver with cuda_graphs=False beside it:
    its cycles, stages and rel (which must equal the graph path's) and its
    wall times;
  * device time per cycle (the cycle captured in a CUDA graph and replayed,
    evostencils_torch/utils/timing.per_cycle_time) and wall time of one
    eager cycle (wall_cycle_time);
  * device time per restart: one float64 residual r = f − A·u plus the
    float32 cast, timed the same way;
  * host time of a solve's verdict: the exact float64 residual in numpy
    and two norms (host clock);
  * device compute = cycles × per-cycle + (stages + 1) × per-restart;
  * modeled bytes per cycle (models/roofline.estimate_traffic, an unfused
    count) and their rate as a share of the H100's 3.35 TB/s;
  * the sweep kernel's launches by grid size during the solver's solves.

Usage:
  python3 scripts/torch_headline_1024.py --predicted
  python3 scripts/torch_headline_1024.py --predicted \\
      --champion artifacts/paper_protocol/individual_1_tuned.txt
  python3 scripts/torch_headline_1024.py --cpu --min-level 3 --max-level 6

Runs on the GPU; without CUDA it stops unless --cpu is given (on the CPU
every time is a host time).  Each call writes its rows as one JSON file
under chiprun_out/ (--json to choose the path).
"""

import argparse
import collections
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from evostencils_torch.backend.device_solve import staged_solver_for_expression
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.models.roofline import H100_HBM_BANDWIDTH, PerformanceEvaluator
from evostencils_torch.ops import rb_sweep
from evostencils_torch.ops.stencil_ops import numpy_l2_norm
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from evostencils_torch.utils.timing import per_cycle_time, wall_cycle_time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def restart_time(apply_a64, u64, f64, iters=20, repeats=5):
    """Seconds of one restart: the float64 residual r = f − A·u plus the
    float32 cast that re-seeds the next stage, timed as per_cycle_time
    times a cycle (graph replays on the card); the 1e-30-scaled feedback
    keeps every iteration's result in use, as the reference's."""

    def step(u, f):
        fs = tuple((ff - aa).to(torch.float32) for ff, aa in zip(f, apply_a64(u)))
        return tuple(a + 1e-30 * b.to(torch.float64) for a, b in zip(u, fs))

    return per_cycle_time(step, u64, f64, iters=iters, repeats=repeats)


def host_verdict_time(generator, operator, f64_rhs, repeats=3):
    """Host seconds of a solve's verdict: the exact float64 residual of an
    iterate in numpy and the two norms a solve takes (of f and of the
    residual), the smallest of `repeats`."""
    u = tuple(np.zeros_like(x) for x in f64_rhs)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        r = generator._host_residual(operator, u, f64_rhs)
        numpy_l2_norm(f64_rhs), numpy_l2_norm(r)
        times.append(time.perf_counter() - t0)
    return min(times)


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--min-level", type=int, default=6)
    parser.add_argument("--max-level", type=int, default=10)
    parser.add_argument("--target", type=float, default=1e-10)
    parser.add_argument("--repeats", type=int, default=9)
    parser.add_argument("--champion", action="append", default=[],
                        help="artifact file with a champion tree string")
    parser.add_argument("--tune", action="store_true",
                        help="gradient-retune champion ω at this size")
    parser.add_argument("--no-kernels", action="store_true",
                        help="the plain torch sweep instead of the CUDA kernel")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (small grids; every time is a host time)")
    parser.add_argument("--predicted", action="store_true",
                        help="predicted-cycle stages from the measured ρ (no per-cycle "
                             "residual norms or stall hunting): cycle counts track "
                             "1/log(ρ)")
    parser.add_argument("--compare-eager", action="store_true",
                        help="also solve with cuda_graphs=False (the same bodies run "
                             "eagerly) and report both")
    parser.add_argument("--json", default=None,
                        help="where to write the rows (default "
                             "chiprun_out/torch_headline_<n>_<device>.json)")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    return args


def _solvers(args, problem, pset, terminal_list):
    solvers = []
    for pre, post in ((2, 1), (2, 2)):
        expr = generate_v_cycle(terminal_list, problem.rhs(), pre_smoothing=pre,
                                post_smoothing=post)
        solvers.append((f"textbook V({pre},{post})", expr, None))
    for path in args.champion:
        tree_string, omegas = parse_champion_file(path)
        expr = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
        name = os.path.basename(path).replace(".txt", "")
        if omegas is not None and not args.tune:
            # The stored tuned ω go into the expression, so the ρ
            # measurement and the lowering both see them; on a count
            # mismatch the grammar string's own factors stay.
            if apply_stored_omegas(expr, omegas, label=path):
                name += " (tuned ω)"
            omegas = None
        if args.tune:
            from evostencils_torch.optimization.relaxation import tune_relaxation_factors

            lowering = CycleLowering(
                problem.dtype, "cpu" if args.cpu else "cuda", use_kernels=False)
            tune_relaxation_factors(expr, problem, lowering=lowering, iterations=60)
            omegas = None  # the factors are set in place on the expression
            name += " (retuned)"
        solvers.append((name, expr, omegas))
    return solvers


def run(argv=None) -> list:
    """Parse `argv`, solve every solver, print the table, write the JSON
    file; returns the rows."""
    args = parse_arguments(argv)
    sys.setrecursionlimit(100000)
    device = torch.device("cpu" if args.cpu else "cuda")
    problem = poisson_2d(min_level=args.min_level, max_level=args.max_level,
                         dtype=torch.float32)
    pset, terminal_list = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=args.max_level - args.min_level,
        maximum_local_system_size=8,
    )
    operator = terminal_list[0].operator
    solvers = _solvers(args, problem, pset, terminal_list)

    use_kernels = not args.no_kernels
    lowering32 = CycleLowering(torch.float32, device, use_kernels=use_kernels)
    lowering64 = CycleLowering(torch.float64, device, use_kernels=False)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device)
    perf = PerformanceEvaluator()
    u0_32, f_32 = problem.initial_state(torch.float32, device=device)

    # On the CPU every time is a host time, never a device metric.
    clock = "device" if device.type == "cuda" else "host"
    rows = []
    t_restart = None
    for name, expr, omegas in solvers:
        _, rho, _ = generator.generate_and_evaluate(expr, evaluation_samples=1)
        predicted = args.predicted and rho < 1.0

        def timed_solves(cuda_graphs=None):
            solve, f64_rhs = staged_solver_for_expression(
                lowering32, expr, operator, problem, generator,
                omegas=omegas, target=args.target, fused=True,
                lowering64=lowering64,
                rho=float(rho) if predicted else None, calibrate_floor=predicted,
                cuda_graphs=cuda_graphs,
            )
            result = solve(f_32, f64_rhs)
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                result = solve(f_32, f64_rhs)
                times.append(time.perf_counter() - t0)
            times.sort()
            return solve, result, times[0], times[len(times) // 2]

        before = collections.Counter(rb_sweep.launches)
        solve, (cycles, rel, stages), t_min, t_med = timed_solves()
        launches = collections.Counter(rb_sweep.launches)
        launches.subtract(before)
        floor = getattr(solve, "measured_floor", None)
        eager = None
        if args.compare_eager:
            eager_solve, result, e_min, e_med = timed_solves(cuda_graphs=False)
            eager_floor = getattr(eager_solve, "measured_floor", None)
            eager = {"cycles": int(result[0]), "rel_residual": float(result[1]),
                     "stages": int(result[2]), "measured_floor": eager_floor,
                     "wall_min_ms": 1e3 * e_min, "wall_med_ms": 1e3 * e_med,
                     "bitwise_equal": (tuple(result), eager_floor)
                     == ((cycles, rel, stages), floor)}

        if omegas is not None:
            pstep, _ = lowering32.lower_parameterized(expr)
            om = torch.as_tensor(omegas, dtype=torch.float32).to(device)
            step = lambda u, f: pstep(u, f, om)  # noqa: E731
        else:
            step = lowering32.lower(expr)
        t_cycle = per_cycle_time(step, u0_32, f_32)
        t_cycle_wall = wall_cycle_time(step, u0_32, f_32)
        if t_restart is None:
            # The same restart and verdict for every solver (A is the
            # problem's operator, not the cycle's): measured once.
            f64_rhs = tuple(np.asarray(x, np.float64) for x in problem.initial_state(
                torch.float32)[1])
            t_verdict = host_verdict_time(generator, operator, f64_rhs)
            u64 = tuple(torch.zeros_like(x, dtype=torch.float64) for x in u0_32)
            f64 = tuple(torch.from_numpy(x).to(device) for x in f64_rhs)
            t_restart = restart_time(lambda u: lowering64.system_apply(operator, u), u64, f64)
        compute_ms = 1e3 * (cycles * t_cycle + (stages + 1) * t_restart)
        bytes_cycle = perf.estimate_traffic(expr)
        rate = bytes_cycle / t_cycle
        rows.append({
            "solver": name,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "n": 2 ** args.max_level - 1,
            "rho": float(rho),
            "cycles": int(cycles),
            "stages": int(stages),
            "rel_residual": float(rel),
            "reached_target": bool(rel <= args.target),
            "measured_floor": floor,
            "wall_min_ms": 1e3 * t_min,
            "wall_med_ms": 1e3 * t_med,
            # The solver's CUDA graphs: captured once, at its construction.
            "cuda_graphs": solve.graphs["captures"] > 0,
            "captures": solve.graphs["captures"],
            "capture_s": solve.graphs["capture_s"],
            "graph_bytes": solve.graphs["bytes"],
            "eager": eager,
            "t_cycle_us": 1e6 * t_cycle,
            "t_cycle_wall_us": 1e6 * t_cycle_wall,
            "t_restart_us": 1e6 * t_restart,
            # The host's float64 verdict of one solve (host clock).
            "host_verdict_ms": 1e3 * t_verdict,
            # Device time on the card; host time on the CPU.
            "clock": "cuda graph replays" if device.type == "cuda" else "host perf_counter",
            "compute_ms": compute_ms,
            "modeled_bytes_per_cycle": bytes_cycle,
            "modeled_GBps": rate / 1e9,
            "share_of_hbm": rate / H100_HBM_BANDWIDTH,
            "rb_sweep_launches_by_shape": {
                f"{r}x{c}": n for (r, c), n in sorted(launches.items()) if n},
        })
        print(f"[{name}] rho={rho:.4f} cycles={cycles} stages={stages} rel={rel:.2e} "
              f"{clock}={compute_ms:.3f}ms wall_min={1e3 * t_min:.1f}ms "
              f"captures={solve.graphs['captures']} ({solve.graphs['capture_s']:.2f}s, "
              f"{solve.graphs['bytes'] / 2**20:.1f}MiB) "
              + (f"eager wall_min={eager['wall_min_ms']:.1f}ms equal={eager['bitwise_equal']} "
                 if eager else "") +
              f"t_cycle={1e6 * t_cycle:.1f}us (wall {1e6 * t_cycle_wall:.1f}us) "
              f"t_restart={1e6 * t_restart:.1f}us host_verdict={1e3 * t_verdict:.1f}ms "
              f"floor={floor if floor is None else f'{floor:.1e}'} "
              f"bytes/cycle={bytes_cycle / 1e6:.2f}MB", flush=True)

    n = 2 ** args.max_level - 1
    on = rows[0]["device"] if rows else str(device)
    print(f"\n## 2D Poisson {n}² time to {args.target:g} on {on} (staged solve, "
          f"{'CUDA' if use_kernels and device.type == 'cuda' else 'plain torch'} sweep)\n")
    print(f"| solver | ρ | cycles | stages | rel | {clock} compute ms | wall min / med ms | "
          f"per-cycle {clock} µs | per-cycle wall µs | per-restart µs | modeled GB/s | "
          "share of 3.35 TB/s |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['solver']} | {r['rho']:.4f} | {r['cycles']} | {r['stages']} | "
              f"{r['rel_residual']:.2e} | **{r['compute_ms']:.3f}** | "
              f"{r['wall_min_ms']:.1f} / {r['wall_med_ms']:.1f} | {r['t_cycle_us']:.1f} | "
              f"{r['t_cycle_wall_us']:.1f} | {r['t_restart_us']:.1f} | "
              f"{r['modeled_GBps']:.0f} | {100 * r['share_of_hbm']:.1f} % |")
    print(f"\n{clock} compute = cycles × per-cycle + (stages + 1) × per-restart (float64 "
          "residual + float32 cast); the wall times include the host's control (graph "
          "replays on the card, every op eagerly on the CPU), its reads and the host "
          "float64 verification.")
    path = args.json or os.path.join(
        ROOT, "chiprun_out", f"torch_headline_{n}_{device.type}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"args": vars(args), "rows": rows}, fh, indent=1)
    return rows


def main(argv=None) -> int:
    rows = run(argv)
    return 0 if rows and all(r["reached_target"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
