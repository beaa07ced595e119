#!/usr/bin/env python
"""One step of the port on a (dp, sp) device mesh, run under torchrun (the
counterpart of `__graft_entry__.dryrun_multichip`).

  torchrun --nproc_per_node 4 scripts/torch_mesh_dryrun.py
  torchrun --nproc_per_node 2 scripts/torch_mesh_dryrun.py --backend gloo --compare
  torchrun --nproc_per_node 2 scripts/torch_mesh_dryrun.py --cpu --min-level 3 --max-level 5
  torchrun --nproc_per_node 4 scripts/torch_mesh_dryrun.py --problem fas --compare
  torchrun --nproc_per_node 4 scripts/torch_mesh_dryrun.py --problem helmholtz --compare

--problem picks what parts B and C evaluate: `poisson2d` (the default, as
below), `fas` or `helmholtz` (after part A, which is always 2D Poisson).

(A) `batched_sharded_evaluation` on the mesh (mesh_shape(world), or --dp):
    2D Poisson levels 3-5 (31²), float32, a batch of max(dp, 2) instances
    whose right-hand sides are scaled by 1, 2, ..., each split by rows over
    sp and advanced one V(2,2) cycle; it prints the mesh, the batch and
    residual[0], and the lanes must differ.
(B) The 511² textbook V(2,2) (levels 5-9, depth 4, float32) through
    `TorchProgramGenerator(mesh=...)`, one evaluation sample: ρ, the
    iterations, ms to target, the backend and the transfer route, the world
    size and every rank's rows of the finest grid, and the red-black kernel's
    launches on this rank (0: the mesh path runs the plain ops).
    With --compare, rank 0 then evaluates the same cycle unsharded with
    `use_kernels=False` (ρ within 1e-5 relative, equal iterations) and on
    the default route (ρ within 2 %, iterations ±1).
    --problem fas: FAS -Δu + γ·u·eᵘ = f, levels 5-9 (511²), float32, the
    stored champion (artifacts/fas_champion_r5.txt, a depth-4 tree: five
    levels) and the textbook Newton V(2,2) (the string of
    artifacts/fas_textbook_V22_jacobi_newton.txt at any depth): ρ, the
    iterations, ms to target and ms per cycle of each.  --compare: the
    champion's ρ within 2 % and its count within ±1 of the unsharded run;
    the textbook's ρ comes from the stall rule (every FAS cycle stagnates
    after one cycle, so its ρ follows the rounding): printed, not judged.
    --problem helmholtz: 2D Helmholtz, levels 3-7 (127²), k = --k (80),
    complex128, the outer cap --outer-cap (the protocol's 10,000), the
    textbook V(2,1) ω = 0.6 preconditioning BiCGStab: the
    outer iterations, ρ, the probe's verdict and the stages, ms to target
    and ms per outer iteration.  --compare: both converge, the same probe
    verdict and stages, the count within 10 % of the unsharded run (a
    long BiCGStab run follows the rounding of its inner products).
(C) With --time-levels 9,11: ms per V(2,2) cycle on the mesh with finest
    level L (levels 5-L), the largest over the ranks of the median of
    host spans that end with a device synchronisation, and the share of a
    profiled cycle's host time spent in the halo exchange, the device time
    of the transfer kernels (NCCL's spin while they wait for the peer) and
    the card's idle share without them (torch.profiler, 3 cycles).  For
    fas the textbook Newton V(2,2) cycle (levels 5-L, float32) from the
    manufactured problem's zero guess; for helmholtz ms per outer
    iteration of the V(2,1)-preconditioned BiCGStab (levels 3-L), each
    timed solve capped at OUTER_ITERATIONS.

Rank 0 prints one JSON line with the numbers of each rank, in rank order
(the last lines of the output); --json writes rank 0's to a file.  A failed check exits 1.  The
backend defaults to NCCL on a card and gloo with --cpu; several ranks on
one card need --backend gloo (NCCL refuses two ranks on one GPU), whose
transfers of card tensors go through host buffers.  Every collective is
bounded by --timeout seconds.
"""

import argparse
import json
import math
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.ops import rb_sweep
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.parallel.mesh import (
    batched_sharded_evaluation, build_mesh, init_from_env, mesh_shape, shard_state,
)
from evostencils_torch.problems.fas import fas_2d
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.problems.poisson import poisson_2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEMS = ("poisson2d", "fas", "helmholtz")
# Default (min, max) levels of each problem: the bench's 511², FAS's
# published 5-9, Helmholtz's 127² at k = 80 (h·k = 0.625).
LEVELS = {"poisson2d": (5, 9), "fas": (5, 9), "helmholtz": (3, 7)}
FAS_CHAMPION = os.path.join(ROOT, "artifacts", "fas_champion_r5.txt")
# Part C for helmholtz: outer iterations per timed, capped solve.
OUTER_ITERATIONS = 5

# The reference's CPU virtual-mesh run of part B (MULTICHIP_r05.json): a
# cross-check, not a target.
REFERENCE_B = {"rho": 0.0612, "iterations": 10, "mesh": [2, 4], "device": "JAX, 8 CPU devices"}


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    parser.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                        help="default: nccl on a card, gloo with --cpu")
    parser.add_argument("--dp", type=int, default=None,
                        help="dp of the mesh (default: the reference's factorisation)")
    parser.add_argument("--problem", choices=PROBLEMS, default="poisson2d",
                        help="what parts B and C evaluate")
    parser.add_argument("--min-level", type=int, default=None,
                        help="default: 5 (helmholtz: 3)")
    parser.add_argument("--max-level", type=int, default=None,
                        help="default: 9 (helmholtz: 7)")
    parser.add_argument("--k", type=float, default=80.0, help="helmholtz: the wavenumber")
    parser.add_argument("--outer-cap", type=int, default=None,
                        help="helmholtz: the outer BiCGStab cap (default: the protocol's)")
    parser.add_argument("--replicate-below", type=int, default=64)
    parser.add_argument("--compare", action="store_true",
                        help="rank 0 also evaluates part B unsharded and checks")
    parser.add_argument("--time-levels", default="",
                        help="comma-separated finest levels to time a V(2,2) at (part C)")
    parser.add_argument("--cycles", type=int, default=20, help="timed cycles per level")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="seconds any collective may take")
    parser.add_argument("--json", default=None, help="write rank 0's record here")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    if args.backend is None:
        args.backend = "gloo" if args.cpu else "nccl"
    if args.cpu and args.backend == "nccl":
        parser.error("nccl needs a card")
    low, high = LEVELS[args.problem]
    args.min_level = low if args.min_level is None else args.min_level
    args.max_level = high if args.max_level is None else args.max_level
    return args


def v22(problem, depth):
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields, depth=depth)
    return generate_v_cycle(terminals, problem.rhs(), 2, 2)


def part_a(mesh, device, failures) -> dict:
    problem = poisson_2d(3, 5, dtype=torch.float32)
    lowering = CycleLowering(torch.float32, device, mesh=mesh, replicate_below=4)
    step = lowering.lower(v22(problem, 2))
    operator = problem.finest_operator()
    slab = lowering._slab(operator.grid[0])

    def residual_fn(u, f):
        return sops.l2_norm(sops.tree_sub(f, lowering.system_apply(operator, u)), slab)

    run = batched_sharded_evaluation(step, mesh, residual_fn, n_iterations=1)
    layout = lowering.layout
    batch = max(layout.dp_size, 2)
    u0, f = problem.initial_state(torch.float32, device=device)
    scales = 1.0 + torch.arange(batch, dtype=torch.float32, device=device)
    u_batch = tuple(torch.stack([x] * batch) for x in u0)
    f_batch = tuple(torch.stack([x] * batch) * scales.reshape((batch,) + (1,) * x.ndim)
                    for x in f)
    u_out, residuals = run(u_batch, f_batch)
    residuals = residuals.cpu().tolist()
    if len(residuals) != batch or residuals[0] == residuals[-1]:
        failures.append(f"A: the dp lanes must differ: {residuals}")
    if u_out[0].shape[0] != batch // layout.dp_size:
        failures.append(f"A: {u_out[0].shape[0]} instances on this dp row")
    return {"mesh": {"dp": layout.dp_size, "sp": layout.sp_size}, "batch": batch,
            "grid": list(u0[0].shape), "residuals": residuals,
            "local_shape": list(u_out[0].shape[1:])}


def part_b(args, mesh, device, failures) -> dict:
    problem = poisson_2d(args.min_level, args.max_level, dtype=torch.float32)
    expression = v22(problem, args.max_level - args.min_level)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device, mesh=mesh,
                                      replicate_below=args.replicate_below)
    rb_sweep.launches.clear()
    t0 = time.perf_counter()
    t, rho, iterations = generator.generate_and_evaluate(expression, evaluation_samples=1)
    wall_s = time.perf_counter() - t0
    launches = sum(rb_sweep.launches.values())
    record = {"rho": rho, "iterations": iterations, "ms_to_target": t, "wall_s": wall_s,
              "kernel_launches": launches, "reference_cpu_mesh": REFERENCE_B,
              **layout_record(generator, problem)}
    if not (math.isfinite(t) and t < 1e50 and 0.0 < rho < 0.2):
        failures.append(f"B: sharded V(2,2) t={t} rho={rho}")
    if launches:
        failures.append(f"B: the kernel launched {launches} times on the mesh path")
    return record


def compare_unsharded(args, device, sharded: dict, failures) -> dict:
    """Rank 0 alone: the same evaluation without a mesh, plain ops and the
    default route."""
    problem = poisson_2d(args.min_level, args.max_level, dtype=torch.float32)
    expression = v22(problem, args.max_level - args.min_level)
    out = {}
    for name, use_kernels in (("plain", False), ("default", True)):
        generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device)
        # Before its first evaluation builds a VM on it: the lowering
        # without the kernel, or the default one.
        generator.lowering = CycleLowering(torch.float32, device, use_kernels=use_kernels)
        t, rho, iterations = generator.generate_and_evaluate(expression, evaluation_samples=1)
        out[name] = {"rho": rho, "iterations": iterations, "ms_to_target": t}
    plain, default = out["plain"], out["default"]
    if not (abs(sharded["rho"] - plain["rho"]) <= 1e-5 * plain["rho"]
            and sharded["iterations"] == plain["iterations"]):
        failures.append(f"compare: sharded {sharded['rho']} / {sharded['iterations']} vs "
                        f"unsharded plain {plain['rho']} / {plain['iterations']}")
    if not (abs(sharded["rho"] - default["rho"]) <= 0.02 * default["rho"]
            and abs(sharded["iterations"] - default["iterations"]) <= 1):
        failures.append(f"compare: sharded {sharded['rho']} / {sharded['iterations']} vs "
                        f"unsharded default {default['rho']} / {default['iterations']}")
    return out


def fas_expression(problem, path):
    """A stored FAS grammar string through the problem's FAS primitive set."""
    from evostencils_torch.grammar import gp
    from evostencils_torch.utils.champions import parse_champion_file

    tree_string, _ = parse_champion_file(path)
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level, maximum_local_system_size=8, FAS=True)
    return gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]


def fas_cycles(problem) -> dict:
    return {"champion": fas_expression(problem, FAS_CHAMPION),
            "textbook_newton": fas_newton_v22(problem)}


def fas_newton_v22(problem):
    """The textbook Newton V(2,2) (ω = 1.0, two Newton steps) over the
    problem's levels, as the stored textbook file spells it at 5-9."""
    from evostencils_torch.grammar import gp
    from evostencils_torch.grammar.multigrid import textbook_cycle_string

    pset, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level, maximum_local_system_size=8, FAS=True)
    tree_string = textbook_cycle_string(terminals, 2, 2, FAS=True, smoother_name="jacobi_newton")
    return gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]


def helmholtz_problem(args, max_level=None):
    problem = helmholtz_2d(args.min_level, args.max_level if max_level is None else max_level,
                           k=args.k, dtype=torch.complex128)
    if args.outer_cap:
        problem.outer_solver["max_iterations"] = args.outer_cap
    return problem


def helmholtz_v21(problem):
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level, maximum_local_system_size=8)
    return generate_v_cycle(terminals, problem.rhs(), pre_smoothing=2, post_smoothing=1,
                            omega=0.6)


def evaluation_record(generator, expression) -> dict:
    """One evaluation (one sample): ρ, the iterations, ms to target and per
    iteration, the wall time, the kernel's launches and, for an outer
    solve, the probe's verdict and the stages."""
    rb_sweep.launches.clear()
    t0 = time.perf_counter()
    t, rho, iterations = generator.generate_and_evaluate(expression, evaluation_samples=1)
    wall_s = time.perf_counter() - t0
    converged = t < 1e50
    record = {"rho": rho, "iterations": iterations, "converged": converged,
              "ms_to_target": t if converged else None,
              "ms_per_iteration": t / iterations if converged else None,
              "wall_s": wall_s, "kernel_launches": sum(rb_sweep.launches.values())}
    record.update(generator.last_outer_solve or {})
    return record


def layout_record(generator, problem) -> dict:
    layout = generator.layout
    shape = problem.finest_grid[0].interior_shape
    return {"backend": layout.backend, "route": layout.route(generator.device),
            "world_size": dist.get_world_size(), "finest": list(shape),
            "rows": [list(b) for b in layout.bounds(shape)],
            "sharded_levels": [
                lvl for lvl in range(problem.min_level, problem.max_level + 1)
                if layout.slab(problem.grid_at(lvl)[0].interior_shape) is not None],
            "counts": dict(layout.counts), "vm_stats": generator.vm_stats()}


def part_b_fas(args, mesh, device, failures) -> dict:
    problem = fas_2d(args.min_level, args.max_level, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device, mesh=mesh,
                                      replicate_below=args.replicate_below)
    cycles = {name: evaluation_record(generator, expression)
              for name, expression in fas_cycles(problem).items()}
    for name, record in cycles.items():
        if record["kernel_launches"]:
            failures.append(f"B: {name} launched the kernel {record['kernel_launches']} times")
    champion = cycles["champion"]
    if not (champion["converged"] and 0.0 < champion["rho"] < 1.0):
        failures.append(f"B: the FAS champion on the mesh: {champion}")
    return {"problem": "fas", "cycles": cycles, **layout_record(generator, problem)}


def part_b_helmholtz(args, mesh, device, failures) -> dict:
    problem = helmholtz_problem(args)
    generator = TorchProgramGenerator(problem, dtype=problem.dtype, device=device, mesh=mesh,
                                      replicate_below=args.replicate_below)
    record = evaluation_record(generator, helmholtz_v21(problem))
    if record["kernel_launches"]:
        failures.append(f"B: the kernel launched {record['kernel_launches']} times")
    if not (record["converged"] and 0.0 < record["rho"] < 1.0):
        failures.append(f"B: Helmholtz V(2,1) on the mesh: {record}")
    return {"problem": "helmholtz", "k": args.k, "dtype": "complex128",
            "cap": problem.outer_solver["max_iterations"], **record,
            **layout_record(generator, problem)}


def compare_fas(args, device, sharded: dict, failures) -> dict:
    """Rank 0 alone: both FAS cycles unsharded; the champion must agree."""
    problem = fas_2d(args.min_level, args.max_level, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device)
    out = {name: evaluation_record(generator, expression)
           for name, expression in fas_cycles(problem).items()}
    mesh, plain = sharded["cycles"]["champion"], out["champion"]
    if not (abs(mesh["rho"] - plain["rho"]) <= 0.02 * plain["rho"]
            and abs(mesh["iterations"] - plain["iterations"]) <= 1):
        failures.append(f"compare: FAS champion {mesh['rho']} / {mesh['iterations']} vs "
                        f"unsharded {plain['rho']} / {plain['iterations']}")
    return out


def compare_helmholtz(args, device, sharded: dict, failures) -> dict:
    """Rank 0 alone: the V(2,1) unsharded; the same verdicts, the count
    within 10 %."""
    problem = helmholtz_problem(args)
    generator = TorchProgramGenerator(problem, dtype=problem.dtype, device=device)
    plain = evaluation_record(generator, helmholtz_v21(problem))
    if not (plain["converged"] and sharded["converged"]
            and (plain["probe"], plain["stages"]) == (sharded["probe"], sharded["stages"])
            and abs(sharded["iterations"] - plain["iterations"]) <= 0.1 * plain["iterations"]):
        failures.append(f"compare: Helmholtz on the mesh {sharded} vs unsharded {plain}")
    return plain


def timed_unit(args, mesh, device, level):
    """(layout, finest shape, unit, run_once) of part C at finest level
    `level`: run_once() runs one cycle or one capped outer solve and returns
    how many units (cycles, outer iterations) it ran."""
    if args.problem == "helmholtz":
        problem = helmholtz_problem(args, level)
        generator = TorchProgramGenerator(problem, dtype=problem.dtype, device=device, mesh=mesh,
                                          replicate_below=args.replicate_below)
        (solve, _), omegas = generator._build_outer_solver(
            helmholtz_v21(problem), probe_iterations=OUTER_ITERATIONS)
        f = generator._to_device(problem.initial_state(problem.dtype)[1])
        return (generator.layout, problem.finest_grid[0].interior_shape, "outer_iteration",
                lambda: solve(f, omegas)[3])
    if args.problem == "fas":
        problem = fas_2d(args.min_level, level, dtype=torch.float32)
        expression = fas_newton_v22(problem)
        u0, f0 = problem.initial_state(torch.float32)
    else:
        problem = poisson_2d(args.min_level, level, dtype=torch.float32)
        expression = v22(problem, level - args.min_level)
        shape = problem.finest_grid[0].interior_shape
        u0 = (np.random.default_rng(1).standard_normal(shape).astype(np.float32),)
        f0 = (np.zeros(shape, np.float32),)
    lowering = CycleLowering(torch.float32, device, mesh=mesh,
                             replicate_below=args.replicate_below)
    step = lowering.lower(expression)
    layout = lowering.layout
    state = {"u": tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in shard_state(u0, layout))}
    f = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
              for x in shard_state(f0, layout))

    def run_once():
        state["u"] = step(state["u"], f)
        return 1

    return layout, problem.finest_grid[0].interior_shape, "cycle", run_once


def part_c(args, mesh, device, level) -> dict:
    """ms per cycle (per outer iteration for helmholtz) with finest level
    `level`, and the exchange's share of a profiled run."""
    layout, shape, unit, run_once = timed_unit(args, mesh, device, level)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()

    for _ in range(3):
        run_once()
    times = []
    for _ in range(args.cycles):
        sync()
        t0 = time.perf_counter()
        units = run_once()
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / max(units, 1))
    ms = 1e3 * float(np.median(times))
    ms_max = layout.all_reduce_max(ms, device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        profiled = sum(run_once() for _ in range(3))
        if cuda:
            torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    device_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events)
    # NCCL's kernels, or the host route's copies.  An NCCL send/recv kernel
    # spins on the card until its peer arrives, so its span is transfer and
    # wait, not work: the idle share counts the other device time.
    transfer_us = sum(e.time_range.elapsed_us() for e in device_events
                      if "nccl" in e.name.lower() or "memcpy" in e.name.lower())
    halo_us = sum(e.time_range.elapsed_us() for e in events
                  if e.name == "mesh.halo_exchange" and e.device_type != torch.autograd.DeviceType.CUDA)
    return {"problem": args.problem, "level": level, "finest": list(shape), "unit": unit,
            f"ms_per_{unit}": ms, f"ms_per_{unit}_max_over_ranks": ms_max,
            "timed_calls": args.cycles,
            "rows": [list(b) for b in layout.bounds(shape)],
            "sharded": layout.slab(shape) is not None,
            "halo_host_share": halo_us / wall_us if wall_us else None,
            f"device_busy_us_per_{unit}": busy_us / profiled,
            f"transfer_device_us_per_{unit}": transfer_us / profiled,
            "idle_share": 1.0 - (busy_us - transfer_us) / wall_us if wall_us and cuda else None,
            "counts": dict(layout.counts)}


def main(argv=None) -> int:
    args = parse_arguments(argv)
    init_from_env(args.backend, args.timeout, cpu=args.cpu)
    device = "cpu" if args.cpu else f"cuda:{torch.cuda.current_device()}"
    rank, world = dist.get_rank(), dist.get_world_size()
    dp, sp = mesh_shape(world, args.dp)
    mesh = build_mesh(world, dp=dp)
    failures = []
    record = {"rank": rank, "world_size": world, "backend": args.backend,
              "device": "cpu" if args.cpu else torch.cuda.get_device_name()}
    record["A"] = part_a(mesh, device, failures)
    if rank == 0:
        a = record["A"]
        print(f"mesh dryrun A OK: mesh={a['mesh']}, batch={a['batch']}, grid={tuple(a['grid'])}, "
              f"residual[0]={a['residuals'][0]:.3e}", flush=True)
    part_b_of, compare_of = {
        "poisson2d": (part_b, compare_unsharded),
        "fas": (part_b_fas, compare_fas),
        "helmholtz": (part_b_helmholtz, compare_helmholtz),
    }[args.problem]
    record["B"] = part_b_of(args, mesh, device, failures)
    b = record["B"]
    if rank == 0:
        head = (f"mesh dryrun B: {args.problem} {b['finest'][0]}² over (dp, sp) = ({dp}, {sp}) "
                f"on {world} ranks ({b['backend']}, route {b['route']}), rows {b['rows']}, "
                f"sharded levels {b['sharded_levels']} ->")
        if args.problem == "poisson2d":
            print(f"{head} V(2,2) rho={b['rho']:.6g}, {b['iterations']} iterations, "
                  f"{b['ms_to_target']:.2f} ms-to-target; the JAX package's CPU virtual mesh "
                  f"(MULTICHIP_r05.json, a cross-check): rho 0.0612 in 10", flush=True)
        else:
            for name, r in (b["cycles"].items() if args.problem == "fas" else [("V(2,1)", b)]):
                print(f"{head} {name}: rho={r['rho']:.6g}, {r['iterations']} iterations, "
                      f"{r['ms_per_iteration']} ms per iteration", flush=True)
    if args.compare:
        # The other ranks wait at the barrier below (bounded by --timeout).
        if rank == 0:
            record["unsharded"] = compare_of(args, device, b, failures)
        dist.barrier()
    record["C"] = [part_c(args, mesh, device, int(level))
                   for level in args.time_levels.split(",") if level]
    record["failures"] = failures
    if rank == 0 and args.json:
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=1)
    # Rank 0 prints every rank's line: lines that several processes write
    # to one pipe at once may interleave.
    records = [None] * world if rank == 0 else None
    dist.gather_object(record, records, dst=0)
    if rank == 0:
        for line in records:
            print(json.dumps(line), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if failures:
        for failure in failures:
            print(f"mesh dryrun FAILED (rank {rank}): {failure}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
