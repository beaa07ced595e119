#!/usr/bin/env python
"""One step of the port on a (dp, sp) device mesh, run under torchrun (the
counterpart of `__graft_entry__.dryrun_multichip`).

  torchrun --nproc_per_node 4 scripts/torch_mesh_dryrun.py
  torchrun --nproc_per_node 2 scripts/torch_mesh_dryrun.py --backend gloo --compare
  torchrun --nproc_per_node 2 scripts/torch_mesh_dryrun.py --cpu --min-level 3 --max-level 5

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
(C) With --time-levels 9,11: ms per V(2,2) cycle on the mesh with finest
    level L (levels 5-L), the largest over the ranks of the median of CUDA-
    event spans (perf_counter on the CPU), and the share of a profiled
    cycle's host time spent in the halo exchange, the device time of the
    transfer kernels (NCCL's spin while they wait for the peer) and the
    card's idle share without them (torch.profiler, 3 cycles).

Every rank prints one JSON line with its numbers (the last line of its
output); --json writes rank 0's to a file.  A failed check exits 1.  The
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
    batched_sharded_evaluation, build_mesh, init_from_env, mesh_shape,
)
from evostencils_torch.problems.poisson import poisson_2d

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
    parser.add_argument("--min-level", type=int, default=5)
    parser.add_argument("--max-level", type=int, default=9)
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
    layout = generator.layout
    rb_sweep.launches.clear()
    t0 = time.perf_counter()
    t, rho, iterations = generator.generate_and_evaluate(expression, evaluation_samples=1)
    wall_s = time.perf_counter() - t0
    launches = sum(rb_sweep.launches.values())
    shape = problem.finest_grid[0].interior_shape
    record = {
        "rho": rho, "iterations": iterations, "ms_to_target": t, "wall_s": wall_s,
        "backend": layout.backend, "route": layout.route(generator.device),
        "world_size": dist.get_world_size(), "finest": list(shape),
        "rows": [list(b) for b in layout.bounds(shape)],
        "sharded_levels": [lvl for lvl in range(args.min_level, args.max_level + 1)
                           if layout.slab(problem.grid_at(lvl)[0].interior_shape) is not None],
        "counts": dict(layout.counts), "kernel_launches": launches,
        "vm_stats": generator.vm_stats(), "reference_cpu_mesh": REFERENCE_B,
    }
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


def part_c(args, mesh, device, level) -> dict:
    """ms per V(2,2) cycle with finest level `level`, and the exchange's
    share of a profiled cycle."""
    problem = poisson_2d(args.min_level, level, dtype=torch.float32)
    lowering = CycleLowering(torch.float32, device, mesh=mesh,
                             replicate_below=args.replicate_below)
    step = lowering.lower(v22(problem, level - args.min_level))
    layout = lowering.layout
    shape = problem.finest_grid[0].interior_shape
    whole = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    slab = layout.slab(shape)
    u = (torch.from_numpy(np.ascontiguousarray(whole if slab is None else slab.cut(whole))).to(
        device),)
    f = tuple(torch.zeros_like(x) for x in u)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()

    for _ in range(3):
        u = step(u, f)
    times = []
    for _ in range(args.cycles):
        sync()
        t0 = time.perf_counter()
        u = step(u, f)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    ms_max = layout.all_reduce_max(ms, device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            u = step(u, f)
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
    return {"level": level, "finest": list(shape), "ms_per_cycle": ms,
            "ms_per_cycle_max_over_ranks": ms_max, "cycles": args.cycles,
            "rows": [list(b) for b in layout.bounds(shape)],
            "sharded": layout.slab(shape) is not None,
            "halo_host_share": halo_us / wall_us if wall_us else None,
            "device_busy_us_per_cycle": busy_us / 3,
            "transfer_device_us_per_cycle": transfer_us / 3,
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
    record["B"] = part_b(args, mesh, device, failures)
    b = record["B"]
    if rank == 0:
        print(f"mesh dryrun B: {b['finest'][0]}² V(2,2) over (dp, sp) = ({dp}, {sp}) on "
              f"{world} ranks ({b['backend']}, route {b['route']}), rows {b['rows']} -> "
              f"rho={b['rho']:.6g}, {b['iterations']} iterations, "
              f"{b['ms_to_target']:.2f} ms-to-target; the JAX package's CPU virtual mesh "
              f"(MULTICHIP_r05.json, a cross-check): rho 0.0612 in 10", flush=True)
    if args.compare:
        # The other ranks wait at the barrier below (bounded by --timeout).
        if rank == 0:
            record["unsharded"] = compare_unsharded(args, device, b, failures)
        dist.barrier()
    record["C"] = [part_c(args, mesh, device, int(level))
                   for level in args.time_levels.split(",") if level]
    record["failures"] = failures
    if rank == 0 and args.json:
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps(record), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if failures:
        for failure in failures:
            print(f"mesh dryrun FAILED (rank {rank}): {failure}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
