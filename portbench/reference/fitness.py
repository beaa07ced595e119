"""The fitness protocols of the two search configurations, in plain PyTorch.

Cycle fitness (2D Poisson, float32 evaluation):
  * ρ: power iteration on the error-propagation operator from a seeded
    random error e0 (numpy's default_rng(seed).standard_normal, rounded to
    float32) and a zero right-hand side, in blocks of ten cycles, each
    cycle's error divided by its norm and the norms' logs summed; a block's
    rate is exp(sum / 10).  Blocks go on while fewer than 8 have run and
    (fewer than 3 have run, or the rate moved by more than 2 % of itself),
    the rate is below 2 and finite.  ρ is the last block's rate.
  * verdict: ρ = 0 reads 1e-16; a non-finite or negative ρ is poisoned
    (∞, ∞, ∞); ρ ≥ 1 diverges (∞, ρ, cap); else iterations =
    ⌈log ε / log ρ⌉, over the cap diverging (∞, ρ, iterations).

Outer-Krylov fitness (Helmholtz): right-preconditioned BiCGStab on the
outer operator with one cycle on (0, ·) as the preconditioner; a probe of
`probe` iterations that kills hopeless preconditioners and seeds the solve
with its iterate, then up to four stages, each solving the error equation
to `target` times its own right-hand side's norm and restarting from the
exact residual; ρ = (final relative residual)^(1 / total iterations).  The
probe runs for every candidate: the port probes the cycles its VM
translates, which every Helmholtz candidate of the benchmark does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 10


def seeded_error(shape, seed: int = 7) -> np.ndarray:
    """The power iteration's start: float32-rounded standard normals."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x.real * x.real + x.imag * x.imag) if x.is_complex()
                      else torch.sum(x * x))


def power_rate(cycle, e0: torch.Tensor):
    """(ρ, cycles run) of cycle(u, f) -> u' from the error e0."""
    e = e0.clone()
    zero = torch.zeros_like(e)
    tiny = torch.finfo(e.real.dtype if e.is_complex() else e.dtype).tiny

    def block(e):
        log_sum = torch.zeros((), dtype=torch.float64, device=e.device)
        for _ in range(BLOCK):
            e = cycle(e, zero)
            n = _norm(e)
            e = e / torch.where(n > 0, n, torch.ones_like(n))
            log_sum = log_sum + torch.log(torch.where(n > 0, n, torch.full_like(n, tiny))).double()
        return e, math.exp(float(log_sum) / BLOCK)

    e, rate = block(e)
    prev, k = 0.0, 1
    while (k < 8 and (k < 3 or abs(rate - prev) > 0.02 * abs(rate)) and rate < 2.0
           and math.isfinite(rate)):
        e, new_rate = block(e)
        prev, rate, k = rate, new_rate, k + 1
    return rate, k * BLOCK


def power_verdict(rate: float, epsilon: float, cap: int, infinity: float = 1e100):
    """(poisoned | diverged | converged, ρ, iterations)."""
    if rate == 0.0:
        rate = 1e-16
    if not math.isfinite(rate) or rate < 0.0:
        return "poisoned", infinity, infinity
    if rate >= 1.0:
        return "diverged", rate, cap
    iterations = int(math.ceil(math.log(epsilon) / math.log(rate)))
    if iterations > cap:
        return "diverged", rate, iterations
    return "converged", rate, iterations


def cycle_class(t: float, rho: float, infinity: float = 1e100) -> str:
    """The class of a program's fitness triple (time, ρ, iterations)."""
    if not (rho < infinity and math.isfinite(rho)):
        return "poisoned"
    if not (t < infinity and math.isfinite(t)):
        return "diverged"
    return "converged"


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.conj(a) * b)


def _safe(den: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(den) < 1e-30, torch.full_like(den, 1e-30), den)


def bicgstab(apply_a, cycle, rhs: torch.Tensor, max_iterations: int, target: float):
    """(x, iterations, final residual norm, initial residual norm) of
    right-preconditioned BiCGStab from x = 0, the shadow residual the
    right-hand side.  The loop runs while iterations < max, ‖r‖ >
    target·‖rhs‖ and ‖r‖ is finite; it returns the last iterate unless a
    smaller residual came earlier or the last is not finite, then the best."""
    zero = torch.zeros_like(rhs)
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    p = rhs.clone()
    rho = _dot(rhs, r)
    res0 = float(_norm(r))
    res = best_res = res0
    best_x = x
    threshold = target * res0
    it = 0
    while it < max_iterations and res > threshold and math.isfinite(res):
        p_hat = cycle(zero, p)
        v = apply_a(p_hat)
        alpha = rho / _safe(_dot(rhs, v))
        s = r - alpha * v
        s_hat = cycle(zero, s)
        t = apply_a(s_hat)
        omega = _dot(t, s) / _safe(_dot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rho_new = _dot(rhs, r)
        beta = (rho_new * alpha) / _safe(rho * omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
        res = float(_norm(r))
        it += 1
        if math.isfinite(res) and res < best_res:
            best_res, best_x = res, x
    chosen = x if math.isfinite(res) and res <= best_res else best_x
    return chosen, it, min(res if math.isfinite(res) else best_res, best_res), res0


def outer_fitness(apply_a, cycle, f: torch.Tensor, target: float, max_iterations: int,
                  probe: int = 128, infinity: float = 1e100):
    """(class, ρ, outer iterations) of the Helmholtz protocol; `apply_a`
    the outer operator, `cycle` the preconditioner cycle(u, f) -> u'.
    The residuals between stages are computed in the tensors' dtype."""
    res0_true = float(_norm(f))
    x_total = torch.zeros_like(f)
    rhs = f
    total_it, rel = 0, 1.0
    if probe and max_iterations > 4 * probe:
        p_x, p_it, p_res, p_res0 = bicgstab(apply_a, cycle, f, probe, target)
        if p_it == 0 or not math.isfinite(p_res) or p_res0 <= 0.0:
            return "poisoned", infinity, infinity
        if p_it >= probe and p_res > 0.0:
            p_rate = (p_res / p_res0) ** (1.0 / p_it)
            if p_rate >= 1.0:
                return "diverged", p_rate, max_iterations
            projected = math.log(target) / math.log(p_rate)
            if projected > 2.0 * max_iterations:
                return "diverged", p_rate, int(min(projected, 10 * max_iterations))
        if p_res < p_res0:
            r_probe = f - apply_a(p_x)
            seeded = float(_norm(r_probe)) / res0_true
            if math.isfinite(seeded) and seeded < rel:
                x_total, rhs, total_it, rel = p_x, r_probe, p_it, seeded
    stage1_rho = None
    for _ in range(4):
        if rel <= target:
            break
        x, it, res, res0s = bicgstab(apply_a, cycle, rhs, max_iterations, target)
        if it == 0 or not math.isfinite(res) or res0s <= 0.0:
            return "poisoned", infinity, infinity
        if stage1_rho is None:
            stage1_rho = (res / res0s) ** (1.0 / it) if res > 0.0 else infinity
        total_it += it
        x_total = x_total + x
        r = f - apply_a(x_total)
        new_rel = float(_norm(r)) / res0_true
        if new_rel <= target:
            rel = new_rel
            break
        if total_it >= max_iterations or new_rel >= rel:
            rel = min(rel, new_rel)
            rho = max(rel ** (1.0 / total_it), stage1_rho)
            return "diverged", rho if math.isfinite(rho) else infinity, total_it
        rel, rhs = new_rel, r
    if rel > target:
        return "diverged", rel ** (1.0 / max(total_it, 1)), total_it
    return "converged", rel ** (1.0 / total_it), total_it
