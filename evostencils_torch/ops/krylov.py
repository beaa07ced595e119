"""Krylov-subspace solvers over system states (tuples of tensors; the
counterpart of evostencils_tpu/ops/krylov.py).

Each solver takes a matrix-free `apply_a(state) -> state` closure.  The
fixed-count solvers run their `iterations` as a Python loop (the
reference's `lax.fori_loop`) and never read a value back to the host.
`preconditioned_bicgstab` also takes an `apply_m` preconditioner closure,
the evolved multigrid cycle of the Helmholtz configuration, and stops on
its residual: the reference's `lax.while_loop` is a host loop here that
reads the residual norm once per iteration, so the iteration count, which
is the fitness, is decided by the same test on the same values.  One
iteration is `BicgstabLoop.iteration`, on static buffers, with the scalars
and the best-iterate update on the device: three glue bodies around its
two preconditioner cycles, which the fitness captures in CUDA graphs and
replays (backend/graphs.py), the cycles being the problem's interpreter
or a lowered structure's own graph.

Plain torch: the reductions and updates are library calls, as the
reference left them to XLA.  With a `slab` (a state split by rows over a
device mesh, parallel/mesh.py) every inner product is all-reduced, so each
rank computes the same coefficients and takes the same decisions.  With
`members=True` (fields shaped (B, *grid), the group path's batch) the
fixed-count solvers take one inner product per member, viewed (B, 1, …),
so every member runs its own recurrence.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from evostencils_torch.backend import graphs
from evostencils_torch.ops.stencil_ops import (
    dot, per_member, tree_add, tree_scale, tree_sub, zeros_like_state)
from evostencils_torch.utils import profiling

State = Sequence[torch.Tensor]
_EPS = 1e-30


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, with b replaced by _EPS where |b| < _EPS."""
    return a / torch.where(torch.abs(b) < _EPS, torch.full_like(b, _EPS), b)


def _inner(slab, members: bool) -> Callable:
    """The solvers' inner product: a 0-d tensor, or one per member viewed
    to scale the members' fields."""
    if not members:
        return lambda a, b: dot(a, b, slab)
    return lambda a, b: per_member(dot(a, b, slab, members=True), a[0])


def conjugate_gradient(apply_a: Callable, rhs: State, iterations: int,
                       x0: Optional[State] = None, slab=None, members: bool = False) -> State:
    inner = _inner(slab, members)
    x = zeros_like_state(rhs) if x0 is None else tuple(x0)
    r = tree_sub(rhs, apply_a(x)) if x0 is not None else tuple(rhs)
    p = r
    rr = inner(r, r)
    for _ in range(iterations):
        ap = apply_a(p)
        alpha = _safe_div(rr, inner(p, ap))
        x = tree_add(x, tree_scale(alpha, p))
        r = tree_sub(r, tree_scale(alpha, ap))
        rr_new = inner(r, r)
        beta = _safe_div(rr_new, rr)
        p = tree_add(r, tree_scale(beta, p))
        rr = rr_new
    return x


def conjugate_residual(apply_a: Callable, rhs: State, iterations: int, slab=None,
                       members: bool = False) -> State:
    inner = _inner(slab, members)
    x = zeros_like_state(rhs)
    r = tuple(rhs)
    p = r
    ar = apply_a(r)
    ap = ar
    rar = inner(r, ar)
    for _ in range(iterations):
        alpha = _safe_div(rar, inner(ap, ap))
        x = tree_add(x, tree_scale(alpha, p))
        r = tree_sub(r, tree_scale(alpha, ap))
        ar = apply_a(r)
        rar_new = inner(r, ar)
        beta = _safe_div(rar_new, rar)
        p = tree_add(r, tree_scale(beta, p))
        ap = tree_add(ar, tree_scale(beta, ap))
        rar = rar_new
    return x


def minres(apply_a: Callable, rhs: State, iterations: int, slab=None,
           members: bool = False) -> State:
    """MinRes via the conjugate-residual recurrence (symmetric A)."""
    return conjugate_residual(apply_a, rhs, iterations, slab, members)


def bicgstab(apply_a: Callable, rhs: State, iterations: int, slab=None,
             members: bool = False) -> State:
    inner = _inner(slab, members)
    x = zeros_like_state(rhs)
    r = tuple(rhs)
    r_hat = r
    p = r
    rho = inner(r_hat, r)
    for _ in range(iterations):
        v = apply_a(p)
        alpha = _safe_div(rho, inner(r_hat, v))
        s = tree_sub(r, tree_scale(alpha, v))
        t = apply_a(s)
        omega = _safe_div(inner(t, s), inner(t, t))
        x = tree_add(x, tree_add(tree_scale(alpha, p), tree_scale(omega, s)))
        r = tree_sub(s, tree_scale(omega, t))
        rho_new = inner(r_hat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = tree_add(r, tree_scale(beta, tree_sub(p, tree_scale(omega, v))))
        rho = rho_new
    return x


def _residual_norm(r: State, slab=None) -> torch.Tensor:
    """‖r‖ as a 0-d tensor of the state's real dtype."""
    return torch.sqrt(torch.real(dot(r, r, slab)))


def _host_scalar(norm: torch.Tensor):
    """A norm read back to the host as a numpy scalar of its dtype, so the
    stopping test rounds as the reference's does on the device (float32
    for float32 and complex64 states); counted by graphs.read."""
    return (np.float64 if norm.dtype == torch.float64 else np.float32)(graphs.read(norm))


class _ClosureCycle:
    """A preconditioner closure apply_m(state) -> state as a cycle: `f` in,
    `u` out (the cycle protocol of backend/graphs.py); eager only."""

    def __init__(self, apply_m: Callable, like: State):
        self.apply_m = apply_m
        self.u, self.f = zeros_like_state(like), zeros_like_state(like)
        self.lock = threading.Lock()

    def run_cycle(self) -> None:
        for d, x in zip(self.u, self.apply_m(self.f)):
            d.copy_(x)


class BicgstabLoop(graphs.Loop):
    """Right-preconditioned BiCGStab on static buffers shaped like `like`.

    The preconditioner is one cycle on (0, ·): a cycle object (`u`, `f`,
    `lock`, `run_cycle()`: backend/graphs.StepCycle or
    backend/graphs.Interpreter) run in place, or a closure apply_m(state).
    `start` sets up the recurrence from the right-hand side in `rhs`;
    `iteration()` is one outer iteration (two preconditioner and two
    operator applications, the inner products and updates, the residual
    norm and the reference's best-iterate update, all on the device): the
    glue bodies `before_cycles` (the first cycle's input), `between_cycles`
    (its result, the operator, α, s, the second cycle's input) and
    `after_cycles` (the rest) around the two cycles.  `solve` is the host
    loop around them."""

    bodies = ("start", "before_cycles", "between_cycles", "after_cycles")

    def __init__(self, apply_a: Callable, preconditioner, like: State, slab=None):
        super().__init__()
        self.cycle = (preconditioner if hasattr(preconditioner, "run_cycle")
                      else _ClosureCycle(preconditioner, like))
        self.lock = self.cycle.lock
        self.apply_a, self.slab = apply_a, slab
        self.rhs, self.x, self.r, self.p, self.best_x, self.p_hat, self.v, self.s = (
            zeros_like_state(like) for _ in range(8))
        self.rho = torch.zeros((), dtype=like[0].dtype, device=like[0].device)
        self.alpha = self.rho.clone()
        self.res = torch.real(self.rho).clone()
        self.best_res = self.res.clone()

    def parts(self) -> tuple:
        return (self.cycle,) if isinstance(self.cycle, graphs.Loop) else ()

    def start(self) -> None:
        for x, b in zip(self.x, self.best_x):
            x.zero_()
            b.zero_()
        for dst in (self.r, self.p):
            for d, f in zip(dst, self.rhs):
                d.copy_(f)
        self.rho.copy_(dot(self.rhs, self.r, self.slab))
        res = _residual_norm(self.r, self.slab)
        self.res.copy_(res)
        self.best_res.copy_(res)

    def iteration(self) -> None:
        self.run("before_cycles")
        self.cycle.run_cycle()
        self.run("between_cycles")
        self.cycle.run_cycle()
        self.run("after_cycles")

    def _cycle_input(self, state: State) -> None:
        for u, d, x in zip(self.cycle.u, self.cycle.f, state):
            u.zero_()
            d.copy_(x)

    def before_cycles(self) -> None:
        self._cycle_input(self.p)

    def between_cycles(self) -> None:
        # The shadow residual r̂ is r0, the right-hand side.
        for d, x in zip(self.p_hat, self.cycle.u):
            d.copy_(x)
        v = self.apply_a(self.p_hat)
        alpha = _safe_div(self.rho, dot(self.rhs, v, self.slab))
        s = tree_sub(self.r, tree_scale(alpha, v))
        for dst, new in ((self.v, v), (self.s, s)):
            for d, n in zip(dst, new):
                d.copy_(n)
        self.alpha.copy_(alpha)
        self._cycle_input(self.s)

    def after_cycles(self) -> None:
        slab, r_hat, p, rho, alpha, s = self.slab, self.rhs, self.p, self.rho, self.alpha, self.s
        s_hat = self.cycle.u
        t = self.apply_a(s_hat)
        omega = _safe_div(dot(t, s, slab), dot(t, t, slab))
        x = tree_add(self.x, tree_add(tree_scale(alpha, self.p_hat), tree_scale(omega, s_hat)))
        r = tree_sub(s, tree_scale(omega, t))
        rho_new = dot(r_hat, r, slab)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p_new = tree_add(r, tree_scale(beta, tree_sub(p, tree_scale(omega, self.v))))
        res = _residual_norm(r, slab)
        improved = torch.logical_and(torch.isfinite(res), res < self.best_res)
        for b, new in zip(self.best_x, x):
            b.copy_(torch.where(improved, new, b))
        self.best_res.copy_(torch.where(improved, res, self.best_res))
        for dst, new in ((self.x, x), (self.r, r), (self.p, p_new)):
            for d, n in zip(dst, new):
                d.copy_(n)
        self.rho.copy_(rho_new)
        self.res.copy_(res)

    def solve(self, rhs: State, max_iterations: int, target_reduction: float) -> tuple:
        """(x, iterations, final_res_norm), x a copy of the chosen iterate.
        Before every iteration the loop tests `it < max_iterations`, `res >
        target_reduction·res0` and `isfinite(res)`, as the reference's
        `while_loop` condition does; on a breakdown (a NaN in the
        recurrence) it returns the best iterate so far, so the restarted
        outer solve can go on from the last good state."""
        with profiling.span("loop.bicgstab"):
            for d, f in zip(self.rhs, rhs):
                d.copy_(f)
            self.run("start")
            res0 = _host_scalar(self.res)
            threshold = type(res0)(target_reduction) * res0
            res = best_res = res0
            it = 0
            while it < max_iterations and res > threshold and math.isfinite(res):
                self.iteration()
                res = _host_scalar(self.res)
                it += 1
                if math.isfinite(res) and res < best_res:
                    best_res = res
            x = self.x if math.isfinite(res) and res <= best_res else self.best_x
            return (tuple(t.clone() for t in x), it,
                    float(min(res if math.isfinite(res) else best_res, best_res)))


def preconditioned_bicgstab(
    apply_a: Callable,
    apply_m: Callable,
    rhs: State,
    max_iterations: int,
    target_reduction: float,
    slab=None,
) -> tuple:
    """Right-preconditioned BiCGStab, eagerly; returns (x, iterations,
    final_res_norm) with the count as an int and the norm as a float.
    `apply_m(state)` applies the (evolved multigrid) preconditioner; the
    stopping test and the best-iterate rule are `BicgstabLoop.solve`'s."""
    return BicgstabLoop(apply_a, apply_m, rhs, slab).solve(
        rhs, max_iterations, target_reduction)


SOLVERS = {
    "ConjugateGradient": conjugate_gradient,
    "BiCGStab": bicgstab,
    "MinRes": minres,
    "ConjugateResidual": conjugate_residual,
}
