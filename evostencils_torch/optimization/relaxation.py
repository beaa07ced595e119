"""Relaxation-factor tuning of an evolved cycle (the port of
evostencils_tpu/optimization/relaxation.py).

`tune_relaxation_factors` minimises the measured log-contraction of the
cycle with Adam, differentiating with torch.autograd where the reference
uses `jax.value_and_grad`:

    loss(ω) = log ‖C(ω)^5 ê‖,   ê = C(ω)^4 e0 / ‖C(ω)^4 e0‖

on pure error propagation (f ≡ 0, a fixed random error e0), a smooth
surrogate of log ρ.  The relaxation factors enter the lowered step as one
tensor (`CycleLowering.lower_parameterized`), bounded to [0.1, 1.9] by a
sigmoid.  The red-black CUDA kernel has no backward, so the tuner lowers
with `use_kernels=False`, as the reference tunes with `use_pallas=False`:
the masked half-sweeps in plain torch ops.  Every other caller launches
the kernel.  On a device mesh every rank tunes the whole grid on its own
device, as the reference tunes unsharded, and takes rank 0's factors
(`layout`).  The tuner's cycles run eagerly: autograd records them, and a
CUDA graph (backend/graphs.py) would replay no backward; the evaluations
before and after tuning take the generator's graphs.

`tune_outer_relaxation` is the reference's CMA-ES over the ω vector
against a generator's measured iteration count: host code over any
program generator.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir.transformations import collect_cycles
from evostencils_torch.ops import stencil_ops as sops


def contraction_loss(
    expression,
    problem,
    lowering,
    warmup_cycles: int = 4,
    measure_cycles: int = 5,
    omega_bounds: Tuple[float, float] = (0.1, 1.9),
):
    """(loss, to_omegas, params0) of `tune_relaxation_factors`.

    `loss(params)` is the 0-dim log-contraction tensor; `to_omegas` maps the
    unbounded parameters to ω = lo + (hi − lo)·sigmoid(params); `params0`
    holds the expression's current ω as float32 parameters, as in the
    reference."""
    step, omega_values = lowering.lower_parameterized(expression)
    grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
    u0, f = problem.initial_state(problem.dtype, level=grids[0].level, device=lowering.device)
    lo, hi = omega_bounds

    rng = np.random.default_rng(7)
    e0 = tuple(
        torch.from_numpy(rng.standard_normal(tuple(x.shape))).to(dtype=x.dtype, device=x.device)
        for x in u0
    )
    zero_f = tuple(torch.zeros_like(x) for x in f)

    def to_omegas(params):
        # smooth bounding: ω = lo + (hi-lo)·sigmoid(p)
        return lo + (hi - lo) * torch.sigmoid(params)

    t = (torch.tensor(omega_values, dtype=torch.float32, device=lowering.device) - lo) / (hi - lo)
    t = torch.clamp(t, 1e-4, 1 - 1e-4)
    params0 = torch.log(t) - torch.log1p(-t)

    def loss(params):
        omegas = to_omegas(params)
        e = e0
        for _ in range(warmup_cycles):
            e = step(e, zero_f, omegas)
        norm = sops.l2_norm(e)
        eps = 1e-30
        e = tuple(x / (norm + eps) for x in e)
        for _ in range(measure_cycles):
            e = step(e, zero_f, omegas)
        return torch.log(sops.l2_norm(e) + eps)

    return loss, to_omegas, params0


def tune_relaxation_factors(
    expression,
    problem,
    lowering=None,
    iterations: int = 50,
    warmup_cycles: int = 4,
    measure_cycles: Optional[int] = None,
    learning_rate: float = 0.05,
    omega_bounds: Tuple[float, float] = (0.1, 1.9),
    verbose: bool = False,
    layout=None,
):
    """Return (tuned_omegas, loss_history) and write the tuned factors back
    into the expression's Cycle nodes.

    The ω search interval matches the grammar's relaxation-factor
    terminals (np.linspace(0.1, 1.9, 37)), but the tuned values are
    continuous.  `lowering` defaults to `CycleLowering(problem.dtype,
    use_kernels=False)` on the card; a lowering that launches kernels is
    refused, since they have no backward.  With the `layout` of a device
    mesh (parallel/mesh.MeshLayout) the lowering must have no mesh: every
    rank tunes on its own device and then takes rank 0's factors, since
    autograd on a card need not be bitwise deterministic, so that every
    rank writes back the same ω.
    """
    if lowering is None:
        lowering = CycleLowering(problem.dtype, use_kernels=False)
    if lowering.use_kernels:
        raise ValueError("the ω tuner differentiates through plain torch ops: "
                         "pass a lowering built with use_kernels=False")
    if lowering.layout is not None:
        raise ValueError("the ω tuner runs on one device: pass a lowering without a mesh")
    if measure_cycles is None:
        measure_cycles = 5
    loss_fn, to_omegas, params = contraction_loss(
        expression, problem, lowering, warmup_cycles, measure_cycles, omega_bounds)

    # Adam
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    beta1, beta2, adam_eps = 0.9, 0.999, 1e-8
    best = (math.inf, params)
    history: List[float] = []
    for t in range(1, iterations + 1):
        p = params.detach().requires_grad_(True)
        value_tensor = loss_fn(p)
        (grad,) = torch.autograd.grad(value_tensor, p)
        value = float(value_tensor.detach())
        history.append(value)
        if value < best[0] and math.isfinite(value):
            best = (value, params)
        if not bool(torch.all(torch.isfinite(grad))):
            break
        m = beta1 * m + (1 - beta1) * grad
        v = beta2 * v + (1 - beta2) * grad * grad
        m_hat = m / (1 - beta1**t)
        v_hat = v / (1 - beta2**t)
        params = params - learning_rate * m_hat / (torch.sqrt(v_hat) + adam_eps)
        if verbose and t % 10 == 0:
            print(f"tune step {t}: per-cycle log-contraction "
                  f"{value / measure_cycles:.4f}", flush=True)

    tuned = [float(w) for w in to_omegas(best[1])]
    if layout is not None:
        tuned = layout.broadcast_values(tuned, lowering.device)
    # Write the tuned factors back into the IR (canonical slot order).
    for cycle, omega in zip(collect_cycles(expression), tuned):
        cycle.relaxation_factor = omega
    return tuned, history


def tune_outer_relaxation(
    expression,
    generator,
    iterations: int = 10,
    sigma: float = 0.12,
    omega_bounds: Tuple[float, float] = (0.1, 1.9),
    population_size: Optional[int] = None,
    seed: int = 0,
    verbose: bool = False,
):
    """CMA-ES tuning of a preconditioner cycle's ω vector against the
    generator's measured iteration count (the reference's objective for the
    outer Krylov solve of Helmholtz, which is integer-valued and so tuned
    derivative-free).  Every candidate is one `generate_and_evaluate`.

    Returns (tuned_omegas, best_iterations); the expression's Cycle nodes
    are left holding the best ω found.
    """
    from evostencils_torch.optimization.intergrid_transfer import CMAES

    cycles = collect_cycles(expression)
    if not cycles:
        return [], math.inf
    x0 = np.array([float(c.relaxation_factor) for c in cycles])
    lo, hi = omega_bounds

    def set_omegas(ws):
        ws = np.clip(ws, lo, hi)
        for c, w in zip(cycles, ws):
            c.relaxation_factor = float(w)
        return ws

    def fitness(ws):
        set_omegas(ws)
        t, _, it = generator.generate_and_evaluate(
            expression, evaluation_samples=1
        )
        if not math.isfinite(t) or t >= 1e100:
            # Failure: order capped runs by how far they got.
            return 1e6 + float(it)
        # Iterations dominate; time breaks ties between equal counts.
        return float(it) + 1e-6 * float(t)

    best_f = fitness(x0)
    best_w = x0.copy()
    if verbose:
        print(f"tune_outer start: {best_f:.2f} with ω={x0.round(3).tolist()}",
              flush=True)
    es = CMAES(x0, sigma, population_size=population_size, seed=seed)
    for g in range(iterations):
        sols = es.ask()
        fits = np.array([fitness(w) for w in sols])
        es.tell(sols, fits)
        i = int(fits.argmin())
        if fits[i] < best_f:
            best_f = float(fits[i])
            best_w = np.clip(sols[i], lo, hi).copy()
        if verbose:
            print(f"tune_outer gen {g}: best {best_f:.2f} "
                  f"(gen min {fits.min():.2f})", flush=True)
    tuned = set_omegas(best_w)
    return [float(w) for w in tuned], (
        best_f if best_f < 1e6 else math.inf
    )
