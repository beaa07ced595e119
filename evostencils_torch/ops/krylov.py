"""Krylov-subspace solvers over system states (tuples of tensors; the
counterpart of evostencils_tpu/ops/krylov.py).

Each solver takes a matrix-free `apply_a(state) -> state` closure.  The
fixed-count solvers run their `iterations` as a Python loop (the
reference's `lax.fori_loop`) and never read a value back to the host.
`preconditioned_bicgstab` also takes an `apply_m` preconditioner closure,
the evolved multigrid cycle of the Helmholtz configuration, and stops on
its residual: the reference's `lax.while_loop` is a host loop here that
reads the residual norm once per iteration, so the iteration count, which
is the fitness, is decided by the same test on the same values.

Plain torch: the reductions and updates are library calls, as the
reference left them to XLA.  With a `slab` (a state split by rows over a
device mesh, parallel/mesh.py) every inner product is all-reduced, so each
rank computes the same coefficients and takes the same decisions.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from evostencils_torch.ops.stencil_ops import dot, tree_add, tree_scale, tree_sub, zeros_like_state

State = Sequence[torch.Tensor]
_EPS = 1e-30


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, with b replaced by _EPS where |b| < _EPS."""
    return a / torch.where(torch.abs(b) < _EPS, torch.full_like(b, _EPS), b)


def conjugate_gradient(apply_a: Callable, rhs: State, iterations: int,
                       x0: Optional[State] = None, slab=None) -> State:
    x = zeros_like_state(rhs) if x0 is None else tuple(x0)
    r = tree_sub(rhs, apply_a(x)) if x0 is not None else tuple(rhs)
    p = r
    rr = dot(r, r, slab)
    for _ in range(iterations):
        ap = apply_a(p)
        alpha = _safe_div(rr, dot(p, ap, slab))
        x = tree_add(x, tree_scale(alpha, p))
        r = tree_sub(r, tree_scale(alpha, ap))
        rr_new = dot(r, r, slab)
        beta = _safe_div(rr_new, rr)
        p = tree_add(r, tree_scale(beta, p))
        rr = rr_new
    return x


def conjugate_residual(apply_a: Callable, rhs: State, iterations: int, slab=None) -> State:
    x = zeros_like_state(rhs)
    r = tuple(rhs)
    p = r
    ar = apply_a(r)
    ap = ar
    rar = dot(r, ar, slab)
    for _ in range(iterations):
        alpha = _safe_div(rar, dot(ap, ap, slab))
        x = tree_add(x, tree_scale(alpha, p))
        r = tree_sub(r, tree_scale(alpha, ap))
        ar = apply_a(r)
        rar_new = dot(r, ar, slab)
        beta = _safe_div(rar_new, rar)
        p = tree_add(r, tree_scale(beta, p))
        ap = tree_add(ar, tree_scale(beta, ap))
        rar = rar_new
    return x


def minres(apply_a: Callable, rhs: State, iterations: int, slab=None) -> State:
    """MinRes via the conjugate-residual recurrence (symmetric A)."""
    return conjugate_residual(apply_a, rhs, iterations, slab)


def bicgstab(apply_a: Callable, rhs: State, iterations: int, slab=None) -> State:
    x = zeros_like_state(rhs)
    r = tuple(rhs)
    r_hat = r
    p = r
    rho = dot(r_hat, r, slab)
    for _ in range(iterations):
        v = apply_a(p)
        alpha = _safe_div(rho, dot(r_hat, v, slab))
        s = tree_sub(r, tree_scale(alpha, v))
        t = apply_a(s)
        omega = _safe_div(dot(t, s, slab), dot(t, t, slab))
        x = tree_add(x, tree_add(tree_scale(alpha, p), tree_scale(omega, s)))
        r = tree_sub(s, tree_scale(omega, t))
        rho_new = dot(r_hat, r, slab)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = tree_add(r, tree_scale(beta, tree_sub(p, tree_scale(omega, v))))
        rho = rho_new
    return x


def _residual_norm(r: State, slab=None):
    """‖r‖ read back to the host as a numpy scalar of the state's real
    dtype, so the stopping test rounds as the reference's does on the
    device (float32 for float32 and complex64 states)."""
    norm = torch.sqrt(torch.real(dot(r, r, slab)))
    return (np.float64 if norm.dtype == torch.float64 else np.float32)(norm.item())


def preconditioned_bicgstab(
    apply_a: Callable,
    apply_m: Callable,
    rhs: State,
    max_iterations: int,
    target_reduction: float,
    slab=None,
) -> tuple:
    """Right-preconditioned BiCGStab; returns (x, iterations, final_res_norm)
    with the count as an int and the norm as a float.

    `apply_m(state)` applies the (evolved multigrid) preconditioner.  Before
    every iteration the loop tests `it < max_iterations`, `res >
    target_reduction·res0` and `isfinite(res)`, as the reference's
    `while_loop` condition does; on a breakdown (a NaN in the recurrence)
    it returns the best iterate so far, so the restarted outer solve can go
    on from the last good state.
    """
    x = zeros_like_state(rhs)
    r = tuple(rhs)
    r_hat = r
    p = r
    rho = dot(r_hat, r, slab)
    res0 = _residual_norm(r, slab)
    threshold = type(res0)(target_reduction) * res0
    res = res0
    it = 0
    best_x, best_res = x, res0
    while it < max_iterations and res > threshold and math.isfinite(res):
        p_hat = apply_m(p)
        v = apply_a(p_hat)
        alpha = _safe_div(rho, dot(r_hat, v, slab))
        s = tree_sub(r, tree_scale(alpha, v))
        s_hat = apply_m(s)
        t = apply_a(s_hat)
        omega = _safe_div(dot(t, s, slab), dot(t, t, slab))
        x = tree_add(x, tree_add(tree_scale(alpha, p_hat), tree_scale(omega, s_hat)))
        r = tree_sub(s, tree_scale(omega, t))
        rho_new = dot(r_hat, r, slab)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p = tree_add(r, tree_scale(beta, tree_sub(p, tree_scale(omega, v))))
        rho = rho_new
        res = _residual_norm(r, slab)
        it += 1
        if math.isfinite(res) and res < best_res:
            best_x, best_res = x, res
    if not (math.isfinite(res) and res <= best_res):
        x = best_x
    return x, it, float(min(res if math.isfinite(res) else best_res, best_res))


SOLVERS = {
    "ConjugateGradient": conjugate_gradient,
    "BiCGStab": bicgstab,
    "MinRes": minres,
    "ConjugateResidual": conjugate_residual,
}
