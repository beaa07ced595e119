"""The ω tuner against the JAX package's, in float64 on the CPU.

The cycle is the reference test's two-level cycle (tests/test_optimizer.py,
TestRelaxationTuning): Single-partitioned collective Jacobi at ω = 0.3, a
coarse-grid correction at ω = 0.3 and another smoothing step, 2D Poisson on
levels 4-5, each side built through its own package.

* The loss: the first entry of both tuners' histories within 1e-9
  relative.  Its gradient: torch.autograd against `jax.value_and_grad` of
  the reference's loss, rebuilt here from the reference's lowering, within
  1e-9 relative.  Both tuners keep their parameters in float32, where the
  two gradients round differently in the last place, so the gradient is
  compared at the same parameters in float64 (and in float32 within f32
  rounding).
* After 50 Adam steps the tuned ω agree within 1e-6, and the port's tuned
  cycle contracts better: ρ_after < 0.7·ρ_before.
* The tuner lowers only with `use_kernels=False`.
* The CMA-ES tuner (`tune_outer_relaxation`) over the port's generator does
  not make the cycle worse and writes its ω back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import base as jax_base
from evostencils_tpu.ir import partitioning as jax_part
from evostencils_tpu.ir import smoother as jax_smoother
from evostencils_tpu.ops import stencil_ops as jax_sops
from evostencils_tpu.optimization.relaxation import (
    tune_relaxation_factors as jax_tune_relaxation_factors,
)
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import multigrid
from evostencils_torch.ir import base, partitioning, smoother
from evostencils_torch.optimization import relaxation
from evostencils_torch.problems.poisson import poisson_2d


def _two_level_cycle(problem, grammar, base_module, part_module, smoother_module):
    _, terminals = grammar.generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors, 5,
        problem.equations, problem.operators, problem.fields, depth=1,
        maximum_local_system_size=4,
    )
    t0 = terminals[0]
    u, f, A = t0.approximation, problem.rhs(), t0.operator

    def smooth_step(ucur, w):
        res = base_module.Residual(A, ucur, f)
        corr = base_module.Multiplication(
            base_module.Inverse(smoother_module.generate_collective_jacobi(A)), res)
        return base_module.Cycle(ucur, f, corr, partitioning=part_module.Single,
                                 relaxation_factor=w)

    ucur = smooth_step(u, 0.3)
    f_c = base_module.Multiplication(t0.restriction, base_module.Residual(A, ucur, f))
    cgc = base_module.Multiplication(base_module.CoarseGridSolver("CGS", t0.coarse_operator), f_c)
    ucur = base_module.Cycle(ucur, f, base_module.Multiplication(t0.prolongation, cgc),
                             relaxation_factor=0.3)
    return smooth_step(ucur, 0.3)


def _jax_side():
    problem = jax_poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
    return problem, _two_level_cycle(problem, jax_multigrid, jax_base, jax_part, jax_smoother)


def _port_side():
    problem = poisson_2d(min_level=4, max_level=5, dtype=torch.float64)
    return problem, _two_level_cycle(problem, multigrid, base, partitioning, smoother)


def _cpu_lowering():
    return CycleLowering(torch.float64, "cpu", use_kernels=False)


def _jax_value_and_grad(problem, expression, params):
    """jax.value_and_grad of the reference tuner's loss
    (evostencils_tpu/optimization/relaxation.py:89-102) at `params`."""
    step, _ = JaxLowering(problem.dtype, use_pallas=False).lower_parameterized(expression)
    u0, f = problem.initial_state(problem.dtype, level=5)
    rng = np.random.default_rng(7)
    e0 = tuple(jnp.asarray(rng.standard_normal(x.shape), dtype=problem.dtype) for x in u0)
    zero_f = tuple(jnp.zeros_like(x) for x in f)

    def loss_fn(p):
        omegas = 0.1 + 1.8 * jax.nn.sigmoid(p)
        e = e0
        for _ in range(4):
            e = step(e, zero_f, omegas)
        norm = jax_sops.l2_norm(e)
        eps = jnp.asarray(1e-30, dtype=jnp.real(norm).dtype)
        e = tuple(x / (norm + eps) for x in e)
        for _ in range(5):
            e = step(e, zero_f, omegas)
        return jnp.log(jnp.real(jax_sops.l2_norm(e)) + eps)

    value, grad = jax.jit(jax.value_and_grad(loss_fn))(jnp.asarray(params))
    return float(value), np.asarray(grad)


def _port_value_and_grad(problem, expression, params):
    loss, _, _ = relaxation.contraction_loss(expression, problem, _cpu_lowering())
    p = torch.from_numpy(np.asarray(params)).requires_grad_(True)
    value = loss(p)
    (grad,) = torch.autograd.grad(value, p)
    return float(value.detach()), grad.numpy()


def _relative(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b)))


def test_loss_and_gradient_match_reference():
    jax_problem, jax_expr = _jax_side()
    problem, expr = _port_side()
    _, _, params0 = relaxation.contraction_loss(expr, problem, _cpu_lowering())
    assert params0.dtype == torch.float32
    params0 = params0.numpy()

    _, jax_history = jax_tune_relaxation_factors(jax_expr, jax_problem, iterations=1)
    _, history = relaxation.tune_relaxation_factors(expr, problem, lowering=_cpu_lowering(),
                                                    iterations=1)
    assert abs(history[0] - jax_history[0]) <= 1e-9 * abs(jax_history[0])

    differences = {}
    for dtype, rtol in ((np.float64, 1e-9), (np.float32, 2.5e-7)):
        params = params0.astype(dtype)
        value_ref, grad_ref = _jax_value_and_grad(jax_problem, jax_expr, params)
        value, grad = _port_value_and_grad(problem, expr, params)
        assert grad.dtype == grad_ref.dtype == dtype
        assert abs(value - value_ref) <= 1e-9 * abs(value_ref)
        assert _relative(grad, grad_ref) <= rtol, (grad, grad_ref)
        if dtype == np.float32:
            assert value == pytest.approx(history[0], rel=1e-9)
        differences[np.dtype(dtype).name] = (abs(value - value_ref) / abs(value_ref),
                                             _relative(grad, grad_ref))
    print("tuner vs reference: relative loss and gradient differences", differences)


def test_tuned_omegas_match_reference_and_improve_rho():
    jax_problem, jax_expr = _jax_side()
    problem, expr = _port_side()
    generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    _, rho_before, _ = generator.generate_and_evaluate(expr, evaluation_samples=1)

    expected, _ = jax_tune_relaxation_factors(jax_expr, jax_problem, iterations=50)
    tuned, history = relaxation.tune_relaxation_factors(
        expr, problem, lowering=_cpu_lowering(), iterations=50)
    assert len(history) == 50
    assert np.max(np.abs(np.asarray(tuned) - np.asarray(expected))) <= 1e-6, (tuned, expected)
    assert all(0.1 <= w <= 1.9 for w in tuned)

    generator._solver_cache.clear()
    _, rho_after, _ = generator.generate_and_evaluate(expr, evaluation_samples=1)
    assert rho_after < 0.7 * rho_before
    print("tuned ω, largest difference to the reference",
          np.max(np.abs(np.asarray(tuned) - np.asarray(expected))),
          "ρ", rho_before, "->", rho_after)


def test_tuner_lowers_only_without_kernels(monkeypatch):
    problem, expr = _port_side()
    with pytest.raises(ValueError):
        relaxation.tune_relaxation_factors(
            expr, problem, lowering=CycleLowering(torch.float64, "cpu"), iterations=1)

    built = []

    def cpu_lowering(dtype, device="cuda", use_kernels=True):
        built.append(use_kernels)
        return CycleLowering(dtype, "cpu", use_kernels=use_kernels)

    monkeypatch.setattr(relaxation, "CycleLowering", cpu_lowering)
    relaxation.tune_relaxation_factors(expr, problem, iterations=1)
    assert built == [False]


def test_cmaes_tuning_does_not_regress():
    problem, expr = _port_side()
    generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    _, _, it_before = generator.generate_and_evaluate(expr, evaluation_samples=1)
    tuned, it_after = relaxation.tune_outer_relaxation(
        expr, generator, iterations=2, population_size=4, seed=5)
    # The objective is the iteration count plus 1e-6 × time in ms.
    assert int(it_after) <= it_before
    assert all(0.1 <= w <= 1.9 for w in tuned)
    _, _, it_again = generator.generate_and_evaluate(expr, evaluation_samples=1)
    assert it_again == int(it_after)
