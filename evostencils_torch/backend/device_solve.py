"""Staged deep solves: time to a 1e-10 relative residual (the port of
evostencils_tpu/backend/device_solve.py).

Why stages: with A-entries of size 4/h² (≈4·2²⁰ at 1023²), the float32
residual r = f − A·u floors near 5e-3·‖f‖ from term cancellation.  So each
stage smooths the error equation A·e = r in float32 from zero, and the next
stage restarts from a residual computed in 64-bit; stage reductions
compound, s stages reach ~(stage floor)^s, far below 1e-10.  The final
verdict is the exact host IEEE-f64 residual (`generator._host_residual`).

The reference compiles each stage into one XLA `while_loop` and emulates
float64 on the TPU (double-single, floor ~1.5e-10).  Here the device work
of a solve is a handful of bodies on static buffers (`StagedLoop`), which a
card captures in CUDA graphs once per solver (backend/graphs.py) and
replays, while the host keeps the loops' control:
  * the cycle: the lowered float32 step as a graphs.StepCycle on the
    static iterate `e` and stage right-hand side `fs`;
  * the reactive stage (`_reactive_stage`): `start` (e ← 0, rn ← ‖fs‖),
    then per cycle the cycle and `post` (rn ← ‖fs − A₃₂·e‖); the host reads
    one float32 norm a cycle and decides in float32, as the reference's
    device loop does, so the executed count and the exit reason match;
  * the predicted stage: `start`, then k replays of the cycle with no read
    between them (k changes from stage to stage; the graph does not);
  * the float64 restart: `begin` (u64 ← 0, fs ← f64) and `restart` (u64 +=
    e, r64 ← f64 − A₆₄·u64 in native float64 on the tensors' device, the
    H100 has IEEE float64, fs ← r64 in float32), one norm read per stage;
  * the verdict from the exact host IEEE-f64 residual, and the polish
    stages when the device loop stopped short, whose right-hand side is
    copied into `fs` outside any body, as the reference does on its host.

Each inner stage stops on any of: stage-target hit, stall (no residual
improvement across a cycle — the f32 floor), iteration cap, divergence.

`staged_solver_for_expression(..., cuda_graphs=None)` runs on graphs on a
card and eagerly on the CPU, as TorchProgramGenerator does;
`cuda_graphs=False` runs the same bodies eagerly, so the two give the same
cycles, stages and residuals.  A body that cannot be captured raises
CudaGraphError: it never runs eagerly in its place.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Tuple

import numpy as np
import torch

from evostencils_torch import numpy_dtype
from evostencils_torch.backend import graphs
from evostencils_torch.ops.stencil_ops import l2_norm as _l2
from evostencils_torch.utils import profiling

# Eager calls of each body before its capture, as utils/timing.py's: they
# fill the lowerings' lazily built device caches (dense coarse solves,
# red-black masks, inverses) before the capture.
CAPTURE_WARMUP = 3


def _host_l2(state) -> float:
    return float(np.sqrt(sum(np.sum(np.abs(np.asarray(x)) ** 2) for x in state)))


def _to_host64(state):
    return tuple(x.detach().cpu().numpy().astype(np.float64) for x in state)


def _copy_host(dst, host_state) -> None:
    """Host arrays into the static tensors `dst`, cast on the host to their
    dtype: a copy outside every body."""
    for d, x in zip(dst, host_state):
        d.copy_(torch.from_numpy(np.ascontiguousarray(x, dtype=numpy_dtype(d.dtype))))


class StagedLoop(graphs.Loop):
    """The device side of a staged solve on static buffers: the cycle
    (graphs.StepCycle on the iterate `e` and the stage right-hand side
    `fs`), the stage's bodies `start` and `post`, and, with `apply_a64`,
    the float64 restart's `begin` and `restart` on `u64` and `f64`.  `rn`
    and `rn64` hold the last float32 and float64 norms, which the host
    reads.  `step(u, f) -> u` is one lowered float32 cycle."""

    def __init__(self, step, apply_a32, shapes, device, apply_a64=None):
        super().__init__()
        like = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
        self.cycle = graphs.StepCycle(lambda u, f, _omegas: step(u, f), (), like)
        self.e, self.fs = self.cycle.u, self.cycle.f
        self.apply_a32, self.apply_a64 = apply_a32, apply_a64
        self.rn = torch.zeros((), dtype=torch.float32, device=device)
        self.bodies = ("start", "post")
        if apply_a64 is not None:
            self.bodies += ("begin", "restart")
            self.u64 = tuple(torch.zeros(s, dtype=torch.float64, device=device) for s in shapes)
            self.f64 = tuple(torch.zeros_like(x) for x in self.u64)
            self.rn64 = torch.zeros((), dtype=torch.float64, device=device)

    def parts(self) -> tuple:
        return (self.cycle,)

    def start(self) -> None:
        for x in self.e:
            x.zero_()
        self.rn.copy_(_l2(self.fs))

    def post(self) -> None:
        self.rn.copy_(_l2(tuple(f - a for f, a in zip(self.fs, self.apply_a32(self.e)))))

    def begin(self) -> None:
        for u in self.u64:
            u.zero_()
        for d, f in zip(self.fs, self.f64):
            d.copy_(f.to(torch.float32))
        self.rn64.copy_(_l2(self.f64))

    def restart(self) -> None:
        for u, x in zip(self.u64, self.e):
            u.add_(x.to(torch.float64))
        r64 = tuple(f - a for f, a in zip(self.f64, self.apply_a64(self.u64)))
        for d, r in zip(self.fs, r64):
            d.copy_(r.to(torch.float32))
        self.rn64.copy_(_l2(r64))


def _reactive_stage(loop, inner_cap, stall_ratio, stage_reduction=None):
    """The shared f32 inner-stage recurrence on `loop.fs`: smooth the error
    equation A·e = r from zero until the stage target (when
    `stage_reduction` is given), the iteration cap, divergence, or a stall
    (per-cycle improvement worse than `stall_ratio`).  Returns run() ->
    (k, rs0, rn, prev_rn), the iterate left in `loop.e` — the single source
    of truth for the stopping semantics used by both staged solvers and the
    floor probe.  `rs0` and the norms are float32 host scalars, compared in
    float32."""
    f32 = np.float32

    def run():
        loop.run("start")
        rs0 = f32(graphs.read(loop.rn))
        k, rn, prev = 0, rs0, f32(np.inf)
        while True:
            improving = k < 2 or rn < f32(stall_ratio) * prev
            keep = k < inner_cap and bool(np.isfinite(rn)) and improving
            if stage_reduction is not None:
                keep = keep and rn > f32(stage_reduction) * f32(rs0)
            if not keep:
                return k, rs0, rn, prev
            loop.cycle.run_cycle()
            loop.run("post")
            k, rn, prev = k + 1, f32(graphs.read(loop.rn)), rn

    return run


def _host_stage(loop, run, r_host):
    """One reactive stage on the float32 cast of the host residual
    `r_host`: (e in host float64, executed cycles, the stage's
    reduction)."""
    with profiling.span("loop.restarts"):
        _copy_host(loop.fs, (np.asarray(x, np.float32) for x in r_host))
        k, rs0, rn, _ = run()
        return _to_host64(loop.e), k, rn / rs0


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
    loop=None,
):
    """Returns (solve, stage): solve(f32_rhs, f64_rhs_np) -> (cycles,
    rel_res, stages); stage(r_host) -> (e_host64, executed, reduction).

    `step(u, f) -> u` is one lowered f32 cycle on field tuples;
    `apply_a32` applies the finest operator in f32 (per-cycle residual
    norms, matching the reference solvers' per-iteration residual
    prints); `host_residual(u64_np_tuple, f64_np_tuple) -> r64_np_tuple`
    computes f − A·u in true host f64 for the right-hand side f that solve
    was given.  Every stage restarts from the host f64 residual.  `loop`: a
    StagedLoop of the same step (captured or not), else a new eager one."""
    loop = loop or StagedLoop(step, apply_a32, shapes, device)
    run = _reactive_stage(loop, inner_cap, stall_ratio, stage_reduction)

    def stage(r_host):
        with loop.lock:
            return _host_stage(loop, run, r_host)

    def solve(f32_rhs, f64_rhs_np):
        with profiling.span("solve", root=True):
            f64 = tuple(np.asarray(x, np.float64) for x in f64_rhs_np)
            r64 = f64
            u64 = tuple(np.zeros(s, np.float64) for s in shapes)
            r0 = _host_l2(r64)
            cycles = 0
            stages = 0
            rel = 1.0
            while rel > target and stages < max_stages and cycles < 1000:
                e, kk, _ = stage(r64)
                if kk == 0:
                    break
                u64 = tuple(u + x for u, x in zip(u64, e))
                with profiling.span("solve.verdict"):
                    r64 = host_residual(u64, f64)
                    new_rel = _host_l2(r64) / r0
                cycles += kk
                stages += 1
                if new_rel >= rel:
                    break  # restart no longer improves — true floor reached
                rel = new_rel
            return cycles, rel, stages

    return solve, stage


def _device_restart_loop(loop, inner, target, max_stages, k0=None, next_k=None):
    """The outer loop both device-restart solvers share, from `loop.f64`:
    while rel > target, rel improves, stages < max_stages and cycles < 500,
    run one inner stage on the float32 cast of the float64 residual in
    `loop.fs` and restart from r = f − A·u in float64 on the device.
    `inner(k) -> executed`; with `next_k`, k is set from each stage's
    reduction.  One norm is read per stage.  Returns (cycles, stages); the
    iterate is `loop.u64`."""
    with profiling.span("loop.restarts"):
        loop.run("begin")
        r0 = graphs.read(loop.rn64)
        cycles, stages, k = 0, 0, k0
        prev_rel = math.inf
        rel = r0 / r0  # the residual of the zero guess is f
        while rel > target and rel < prev_rel and stages < max_stages and cycles < 500:
            executed = inner(k)
            loop.run("restart")
            new_rel = graphs.read(loop.rn64) / r0
            if next_k is not None:
                k = next_k(rel, new_rel, executed)
            cycles += executed
            stages += 1
            prev_rel, rel = rel, new_rel
        return cycles, stages


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
    loop=None,
):
    """Staged solve with every restart on the device: reactive f32 stages,
    each restarted from the float64 residual computed on the device.  The
    outer loop stops on target, stage cap, cycle cap, or no inter-stage
    progress.  The host then verifies against the TRUE IEEE-f64 residual
    and, if the device stopped short of the target, polishes with
    host-restart stages on the same bodies.

    Returns solve(f32_rhs, f64_rhs_np) -> (cycles, rel_true, stages)."""
    loop = loop or StagedLoop(step, apply_a32, shapes, device, apply_a64)
    run_stage = _reactive_stage(loop, inner_cap, stall_ratio, stage_reduction)

    def inner(_k):
        return run_stage()[0]

    def solve(f32_rhs, f64_rhs_np):
        with profiling.span("solve", root=True), loop.lock:
            f64 = tuple(np.asarray(x, np.float64) for x in f64_rhs_np)
            _copy_host(loop.f64, f64)
            cycles, stages = _device_restart_loop(loop, inner, target, max_stages)
            with profiling.span("solve.verdict"):
                u_host = _to_host64(loop.u64)
                r_true = host_residual(u_host, f64)
                r0 = _host_l2(f64)
                rel = _host_l2(r_true) / r0
            # Host-restart polish when the device loop stopped short of the
            # target.
            while rel > target and stages < max_stages and cycles < 1000:
                e, kk, _ = _host_stage(loop, run_stage, r_true)
                if kk == 0:
                    break
                u_host = tuple(u + x for u, x in zip(u_host, e))
                with profiling.span("solve.verdict"):
                    r_true = host_residual(u_host, f64)
                    new_rel = _host_l2(r_true) / r0
                cycles += kk
                stages += 1
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
    loop=None,
):
    """One f32 stage run to stall: probe(fs) -> (k, floor_rel), `fs` a
    float32 state on any device.

    The f32 stage floor is operator- AND cycle-dependent (it scales with
    the rounding noise the cycle injects at the 1/h² operator scale), so
    the conservative 5e-3 default can cost a whole extra restart.  The
    probe measures the achieved stage reduction at stall (<5 %/cycle
    improvement) so the predicted staged solver can size stages to the
    REAL floor."""
    loop = loop or StagedLoop(step, apply_a32, shapes, device)
    run = _reactive_stage(loop, inner_cap, stall_ratio)

    def probe(fs):
        with loop.lock:
            for d, x in zip(loop.fs, fs):
                d.copy_(x)
            k, rs0, rn, prev = run()
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
    loop=None,
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
    with 1/log(ρ).  Here a stage replays its k cycles with no read and
    reads one norm."""
    rho = float(min(max(rho, 1e-6), 0.95))
    # Initial stage length: one extra cycle absorbs the per-restart
    # transient (a restarted error equation starts from a rough state, so
    # the first cycle contracts ~0.5, not ρ).
    k_stage = int(np.clip(np.ceil(np.log(floor_estimate) / np.log(rho)) + 1, 2, inner_cap))
    next_k = _next_stage_length(math.log(floor_estimate), target, inner_cap)
    loop = loop or StagedLoop(step, apply_a32, shapes, device, apply_a64)

    def inner(k):
        loop.run("start")
        for _ in range(k):
            loop.cycle.run_cycle()
        return k

    def solve(f32_rhs, f64_rhs_np):
        with profiling.span("solve", root=True), loop.lock:
            f64 = tuple(np.asarray(x, np.float64) for x in f64_rhs_np)
            _copy_host(loop.f64, f64)
            cycles, stages = _device_restart_loop(
                loop, inner, target, max_stages, k0=k_stage, next_k=next_k)
            with profiling.span("solve.verdict"):
                u_host = _to_host64(loop.u64)
                r_true = host_residual(u_host, f64)
                r0 = _host_l2(f64)
                rel = _host_l2(r_true) / r0
            # Host-restart polish when the device loop stopped short.
            while rel > target and stages < max_stages + 4 and cycles < 1000:
                with profiling.span("loop.restarts"):
                    _copy_host(loop.fs, (np.asarray(x, np.float32) for x in r_true))
                    inner(k_stage)
                    e = _to_host64(loop.e)
                u_host = tuple(u + x for u, x in zip(u_host, e))
                with profiling.span("solve.verdict"):
                    r_true = host_residual(u_host, f64)
                    new_rel = _host_l2(r_true) / r0
                cycles += k_stage
                stages += 1
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
    cuda_graphs=None,
    **kwargs,
):
    """Wire a staged solver from a lowered cycle expression; returns
    (solve, f64_rhs_np).

    `operator` is the finest-level system operator (from the grammar
    terminals); `omegas` optionally overrides relaxation factors via the
    ω-parameterized lowering (for gradient-tuned champions; it goes to the
    device once, as a static float32 tensor); `generator` (a
    TorchProgramGenerator) provides the exact host-f64 residual, against
    the float64 right-hand side each solve is given.  With
    `rho` the predicted solver (and with `calibrate_floor` its floor probe,
    whose result is `solve.measured_floor`), else with `fused` the
    device-restart solver, else the host-restart one.  The device is the
    lowering's.

    `cuda_graphs` (default: on a card) captures the solver's bodies and its
    cycle once, here, into one pool, and every solve replays them; False
    runs the same bodies eagerly; True off a card raises ValueError.
    `solve.graphs` holds the captures, their seconds and the bytes the
    pool and the static buffers hold (zeros when eager)."""
    device = lowering32.device
    if cuda_graphs is None:
        cuda_graphs = device.type == "cuda"
    if cuda_graphs and device.type != "cuda":
        raise ValueError(f"cuda_graphs: no CUDA graphs on {device}")
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

    def host_residual(u64, f64):
        return tuple(generator._host_residual(operator, u64, f64))

    def apply_a64(u):
        return (lowering64 or lowering32).system_apply(operator, u)

    restarts_on_device = rho is not None or fused
    loop = StagedLoop(step, apply_a32, shapes, device,
                      apply_a64 if restarts_on_device else None)
    stats = {"captures": 0, "capture_s": 0.0, "bytes": 0}
    if cuda_graphs:
        t0 = time.perf_counter()
        loop.capture_bodies(warmup=CAPTURE_WARMUP)
        stats = {"captures": loop.captures, "capture_s": time.perf_counter() - t0,
                 "bytes": loop.nbytes}

    if rho is not None:
        measured_floor = None
        if calibrate_floor:
            probe = build_floor_probe(step, apply_a32, shapes, device=device, loop=loop)
            _, floor = probe(tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in f64_rhs))
            measured_floor = float(floor)
            # 2× margin: stage targets sit just above the stall point,
            # where the marginal cycles still contract near ρ.
            kwargs["floor_estimate"] = min(2.0 * measured_floor, 5e-3)

        solve = build_predicted_staged_solver(
            step, apply_a32, apply_a64, host_residual, shapes, rho=rho, device=device,
            loop=loop, **kwargs)
        solve.measured_floor = measured_floor
    elif fused:
        solve = build_fused_staged_solver(
            step, apply_a32, apply_a64, host_residual, shapes, device=device, loop=loop,
            **kwargs)
    else:
        solve, _ = build_staged_solver(step, apply_a32, host_residual, shapes, device=device,
                                       loop=loop, **kwargs)
    solve.graphs = stats
    return solve, f64_rhs
