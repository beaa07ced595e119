"""Staged deep solves: time to a 1e-10 relative residual (the port of
evostencils_tpu/backend/device_solve.py).

Why stages: with A-entries of size 4/h² (≈4·2²⁰ at 1023²), the float32
residual r = f − A·u floors near 5e-3·‖f‖ from term cancellation.  So each
stage smooths the error equation A·e = r in float32 from zero, and the next
stage restarts from a residual computed in 64-bit; stage reductions
compound, s stages reach ~(stage floor)^s, far below 1e-10.  The final
verdict is the exact host IEEE-f64 residual (`generator._host_residual`).

The reference compiles each stage into one XLA `while_loop` and emulates
float64 on the TPU (double-single, floor ~1.5e-10).  Here the loops run on
the host around eager torch cycles:
  * the reactive stage (`_stage_loop`) reads its float32 residual norm once
    a cycle (`.item()`) and decides in float32, as the reference's device
    loop does, so the executed count and the exit reason match;
  * the predicted stage queues its k cycles with no sync and reads one norm
    per stage;
  * the fused and predicted solvers restart from a residual computed in
    native float64 on the tensors' device through a float64 lowering (the
    H100 has IEEE float64; no emulation), then verify, and if needed
    polish, against the exact host residual as the reference does.

Each inner stage stops on any of: stage-target hit, stall (no residual
improvement across a cycle — the f32 floor), iteration cap, divergence.

These solvers stay eager: the fitness's CUDA graphs (backend/graphs.py)
cover the generator's stage, power and outer loops only, and these
staged solvers under graphs are a later item (ROADMAP Queue 1).  Their
device time per cycle comes from utils/timing.py's captured cycle.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from evostencils_torch import numpy_dtype
from evostencils_torch.ops.stencil_ops import l2_norm as _l2


def _host_l2(state) -> float:
    return float(np.sqrt(sum(np.sum(np.abs(np.asarray(x)) ** 2) for x in state)))


def _to_device(host_state, dtype, device):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x, dtype=numpy_dtype(dtype))).to(device)
        for x in host_state
    )


def _to_host64(state):
    return tuple(x.detach().cpu().numpy().astype(np.float64) for x in state)


def _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio, stage_reduction=None,
                device="cuda"):
    """The shared f32 inner-stage recurrence: smooth the error equation
    A·e = r from zero until the stage target (when `stage_reduction` is
    given), the iteration cap, divergence, or a stall (per-cycle
    improvement worse than `stall_ratio`).  Returns run(fs, rs0) ->
    (e, k, rn, prev_rn) — the single source of truth for the stopping
    semantics used by both staged solvers and the floor probe.  `rs0` and
    the norms are float32 host scalars, compared in float32."""
    f32 = np.float32

    def run(fs, rs0):
        e = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
        k, rn, prev = 0, f32(rs0), f32(np.inf)
        while True:
            improving = k < 2 or rn < f32(stall_ratio) * prev
            keep = k < inner_cap and bool(np.isfinite(rn)) and improving
            if stage_reduction is not None:
                keep = keep and rn > f32(stage_reduction) * f32(rs0)
            if not keep:
                return e, k, rn, prev
            e = step(e, fs)
            new_rn = f32(_l2(tuple(f - a for f, a in zip(fs, apply_a32(e)))).item())
            k, rn, prev = k + 1, new_rn, rn

    return run


def build_staged_solver(
    step: Callable,
    apply_a32: Callable,
    host_residual: Callable,
    shapes: Tuple[tuple, ...],
    target: float = 1e-10,
    stage_reduction: float = 1e-5,
    inner_cap: int = 100,
    max_stages: int = 10,
    stall_ratio: float = 0.9,
    device="cuda",
):
    """Returns (solve, stage): solve(f32_rhs, f64_rhs_np) -> (cycles,
    rel_res, stages).

    `step(u, f) -> u` is one lowered f32 cycle on field tuples;
    `apply_a32` applies the finest operator in f32 (per-cycle residual
    norms, matching the reference solvers' per-iteration residual
    prints); `host_residual(u64_np_tuple) -> r64_np_tuple` computes
    f − A·u in true host f64.  Every stage restarts from the host f64
    residual."""

    run = _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio, stage_reduction, device)

    def stage(fs):
        rs0 = np.float32(_l2(fs).item())
        e, k, rn, _ = run(fs, rs0)
        return e, k, rn / rs0

    def solve(f32_rhs, f64_rhs_np):
        r64 = tuple(np.asarray(x, np.float64) for x in f64_rhs_np)
        u64 = tuple(np.zeros(s, np.float64) for s in shapes)
        r0 = _host_l2(r64)
        cycles = 0
        stages = 0
        rel = 1.0
        while rel > target and stages < max_stages and cycles < 1000:
            fs = _to_device((x.astype(np.float32) for x in r64), torch.float32, device)
            e, kk, _ = stage(fs)
            if kk == 0:
                break
            u64 = tuple(u + x for u, x in zip(u64, _to_host64(e)))
            r64 = host_residual(u64)
            cycles += kk
            stages += 1
            new_rel = _host_l2(r64) / r0
            if new_rel >= rel:
                break  # restart no longer improves — true floor reached
            rel = new_rel
        return cycles, rel, stages

    return solve, stage


def _device_restart_loop(inner, apply_a64, f64_dev, shapes, target, max_stages, device,
                         k0=None, next_k=None):
    """The outer loop both device-restart solvers share: while rel > target,
    rel improves, stages < max_stages and cycles < 500, run one inner stage
    on the float32 cast of the float64 residual and restart from
    r = f − A·u in float64 on the device.  `inner(fs, k) -> (e, executed)`;
    with `next_k`, k is set from each stage's reduction.  One norm is read
    per stage.  Returns (u64, cycles, stages)."""
    r0 = _l2(f64_dev).item()
    u64 = tuple(torch.zeros(s, dtype=torch.float64, device=device) for s in shapes)
    r64 = tuple(f64_dev)
    cycles, stages, k = 0, 0, k0
    prev_rel = math.inf
    rel = _l2(r64).item() / r0
    while rel > target and rel < prev_rel and stages < max_stages and cycles < 500:
        e, executed = inner(tuple(x.to(torch.float32) for x in r64), k)
        u64 = tuple(u + x.to(torch.float64) for u, x in zip(u64, e))
        r64 = tuple(f - a for f, a in zip(f64_dev, apply_a64(u64)))
        new_rel = _l2(r64).item() / r0
        if next_k is not None:
            k = next_k(rel, new_rel, executed)
        cycles += executed
        stages += 1
        prev_rel, rel = rel, new_rel
    return u64, cycles, stages


def build_fused_staged_solver(
    step: Callable,
    apply_a32: Callable,
    apply_a64: Callable,
    host_residual: Callable,
    shapes: Tuple[tuple, ...],
    target: float = 1e-10,
    stage_reduction: float = 1e-5,
    inner_cap: int = 60,
    max_stages: int = 8,
    stall_ratio: float = 0.9,
    device="cuda",
):
    """Staged solve with every restart on the device: reactive f32 stages,
    each restarted from the float64 residual computed on the device.  The
    outer loop stops on target, stage cap, cycle cap, or no inter-stage
    progress.  The host then verifies against the TRUE IEEE-f64 residual
    and, if the device stopped short of the target, polishes with
    host-restart stages.

    Returns solve(f32_rhs, f64_rhs_np) -> (cycles, rel_true, stages)."""

    run_stage = _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio, stage_reduction,
                            device)

    def inner(fs, _k):
        rs0 = np.float32(_l2(fs).item())
        e, k, _, _ = run_stage(fs, rs0)
        return e, k

    polish_stage = None

    def solve(f32_rhs, f64_rhs_np):
        nonlocal polish_stage
        f64_dev = _to_device(f64_rhs_np, torch.float64, device)
        u64, cycles, stages = _device_restart_loop(
            inner, apply_a64, f64_dev, shapes, target, max_stages, device)
        u_host = _to_host64(u64)
        r_true = host_residual(u_host)
        r0 = _host_l2(tuple(np.asarray(x, np.float64) for x in f64_rhs_np))
        rel = _host_l2(r_true) / r0
        # Host-restart polish when the device loop stopped short of the
        # target.
        while rel > target and stages < max_stages and cycles < 1000:
            if polish_stage is None:
                _, polish_stage = build_staged_solver(
                    step, apply_a32, host_residual, shapes,
                    target=target, stage_reduction=stage_reduction,
                    inner_cap=inner_cap, stall_ratio=stall_ratio, device=device,
                )
            fs = _to_device((np.asarray(x, np.float32) for x in r_true), torch.float32, device)
            e, kk, _ = polish_stage(fs)
            if kk == 0:
                break
            u_host = tuple(u + x for u, x in zip(u_host, _to_host64(e)))
            r_true = host_residual(u_host)
            cycles += kk
            stages += 1
            new_rel = _host_l2(r_true) / r0
            if new_rel >= rel:
                break
            rel = new_rel
        return cycles, rel, stages

    return solve


def build_floor_probe(
    step: Callable,
    apply_a32: Callable,
    shapes: Tuple[tuple, ...],
    inner_cap: int = 60,
    stall_ratio: float = 0.95,
    device="cuda",
):
    """One f32 stage run to stall: probe(fs) -> (k, floor_rel).

    The f32 stage floor is operator- AND cycle-dependent (it scales with
    the rounding noise the cycle injects at the 1/h² operator scale), so
    the conservative 5e-3 default can cost a whole extra restart.  The
    probe measures the achieved stage reduction at stall (<5 %/cycle
    improvement) so the predicted staged solver can size stages to the
    REAL floor."""

    run = _stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio, device=device)

    def probe(fs):
        rs0 = np.float32(_l2(fs).item())
        _, k, rn, prev = run(fs, rs0)
        return k, min(rn, prev) / rs0

    return probe


def _next_stage_length(log_floor, target, inner_cap):
    """The reference's self-tuning stage length, in host float64: size the
    next stage from this stage's measured effective rate (the asymptotic ρ
    misses the restart transient; the floor caps useful depth), and never
    past the decades remaining to the target."""

    def next_k(rel, new_rel, k):
        achieved = min(max(new_rel / rel, 1e-12), 0.97)
        r_eff = math.log(achieved) / k  # log rate
        k_remaining = math.ceil(math.log(min(max(target / new_rel, 1e-300), 1.0)) / r_eff)
        k_next = int(min(math.ceil(log_floor / r_eff), k_remaining)) + 1
        return int(np.clip(k_next, 2, inner_cap))

    return next_k


def build_predicted_staged_solver(
    step: Callable,
    apply_a32: Callable,
    apply_a64: Callable,
    host_residual: Callable,
    shapes: Tuple[tuple, ...],
    rho: float,
    target: float = 1e-10,
    floor_estimate: float = 5e-3,
    inner_cap: int = 40,
    max_stages: int = 12,
    device="cuda",
):
    """Predicted-cycle staged solve: each stage runs EXACTLY k cycles,
    k = ceil(log(floor)/log(ρ)) + 1 at first — no per-cycle residual
    norms, no stall hunting — then restarts from the float64 device
    residual; the host verifies (and if needed polishes) against true
    IEEE f64.

    Rationale: the f32 stage floor (~5e-3 relative at the 1/h² operator
    scale) caps every stage's reduction, and reactive stall detection
    burns ~2 extra cycles per stage on every solver.  With the measured
    asymptotic ρ (the power iteration the evaluation harness already
    runs), the stage length is known a priori; cycles to target then scale
    with 1/log(ρ).  Here a stage queues its k cycles with no sync and
    reads one norm."""
    rho = float(min(max(rho, 1e-6), 0.95))
    # Initial stage length: one extra cycle absorbs the per-restart
    # transient (a restarted error equation starts from a rough state, so
    # the first cycle contracts ~0.5, not ρ).
    k_stage = int(np.clip(np.ceil(np.log(floor_estimate) / np.log(rho)) + 1, 2, inner_cap))
    next_k = _next_stage_length(math.log(floor_estimate), target, inner_cap)

    def run_k(fs, k):
        e = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
        for _ in range(k):
            e = step(e, fs)
        return e

    def inner(fs, k):
        return run_k(fs, k), k

    def solve(f32_rhs, f64_rhs_np):
        f64_dev = _to_device(f64_rhs_np, torch.float64, device)
        u64, cycles, stages = _device_restart_loop(
            inner, apply_a64, f64_dev, shapes, target, max_stages, device,
            k0=k_stage, next_k=next_k)
        u_host = _to_host64(u64)
        r_true = host_residual(u_host)
        r0 = _host_l2(tuple(np.asarray(x, np.float64) for x in f64_rhs_np))
        rel = _host_l2(r_true) / r0
        # Host-restart polish when the device loop stopped short.
        while rel > target and stages < max_stages + 4 and cycles < 1000:
            fs = _to_device((np.asarray(x, np.float32) for x in r_true), torch.float32, device)
            e = run_k(fs, k_stage)
            u_host = tuple(u + x for u, x in zip(u_host, _to_host64(e)))
            r_true = host_residual(u_host)
            cycles += k_stage
            stages += 1
            new_rel = _host_l2(r_true) / r0
            if new_rel >= rel:
                break
            rel = new_rel
        return cycles, rel, stages

    return solve


def staged_solver_for_expression(
    lowering32,
    expression,
    operator,
    problem,
    generator,
    level=None,
    omegas=None,
    fused=False,
    lowering64=None,
    rho=None,
    calibrate_floor=False,
    **kwargs,
):
    """Wire a staged solver from a lowered cycle expression; returns
    (solve, f64_rhs_np).

    `operator` is the finest-level system operator (from the grammar
    terminals); `omegas` optionally overrides relaxation factors via the
    ω-parameterized lowering (for gradient-tuned champions; it goes to the
    device once, as float32); `generator` (a TorchProgramGenerator)
    provides the exact host-f64 residual.  With `rho` the predicted solver
    (and with `calibrate_floor` its floor probe, whose result is
    `solve.measured_floor`), else with `fused` the device-restart solver,
    else the host-restart one.  The device is the lowering's."""
    device = lowering32.device
    if omegas is not None:
        pstep, _ = lowering32.lower_parameterized(expression)
        om = torch.as_tensor(omegas, dtype=torch.float32).to(device)

        def step(u, f):
            return pstep(u, f, om)
    else:
        step = lowering32.lower(expression)

    def apply_a32(u):
        return lowering32.system_apply(operator, u)

    u0, f0 = problem.initial_state(torch.float32, level=level)
    shapes = tuple(x.shape for x in u0)
    f64_rhs = tuple(np.asarray(x, np.float64) for x in f0)

    def host_residual(u64):
        return tuple(generator._host_residual(operator, u64, f64_rhs))

    def apply_a64(u):
        return (lowering64 or lowering32).system_apply(operator, u)

    if rho is not None:
        measured_floor = None
        if calibrate_floor:
            probe = build_floor_probe(step, apply_a32, shapes, device=device)
            fs0 = _to_device((np.asarray(x, np.float32) for x in f64_rhs), torch.float32, device)
            _, floor = probe(fs0)
            measured_floor = float(floor)
            # 2× margin: stage targets sit just above the stall point,
            # where the marginal cycles still contract near ρ.
            kwargs["floor_estimate"] = min(2.0 * measured_floor, 5e-3)

        solve = build_predicted_staged_solver(
            step, apply_a32, apply_a64, host_residual, shapes, rho=rho, device=device, **kwargs)
        solve.measured_floor = measured_floor
        return solve, f64_rhs

    if fused:
        solve = build_fused_staged_solver(
            step, apply_a32, apply_a64, host_residual, shapes, device=device, **kwargs)
        return solve, f64_rhs

    solve, _ = build_staged_solver(step, apply_a32, host_residual, shapes, device=device, **kwargs)
    return solve, f64_rhs
