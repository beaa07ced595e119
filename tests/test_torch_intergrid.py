"""The port's `optimization/intergrid_transfer.py` against the JAX package's.

* `CMAES`: the same start, step size and seed give the same samples, means
  and step sizes on both sides, bit for bit (both are numpy).
* The two-grid correction with parameterized transfers: both packages build
  the same canonical IR from the same weights.
* `optimize_intergrid_weights` with a caller's fitness and with the LFA
  default: the same stencils, best value and history on both sides.
* The port's generator scores the two-grid correction with full weighting
  and bilinear interpolation on the CPU.
"""

import numpy as np
import pytest
import torch

from evostencils_tpu.ir.transformations import canonical_string as jax_canonical_string
from evostencils_tpu.optimization import intergrid_transfer as jax_intergrid
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.stencils import gallery as jax_gallery
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.optimization import intergrid_transfer
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import gallery

MIN_LEVEL, MAX_LEVEL = 3, 5


def _fw_bilinear(module, gallery_module):
    offsets = module.symmetric_window_offsets(1, 2)
    fw = dict(gallery_module.full_weighting_restriction_stencil(2).entries)
    ml = dict(gallery_module.multilinear_interpolation_stencil(2).entries)
    weights = np.array([fw.get(o, 0.0) for o in offsets] + [ml.get(o, 0.0) for o in offsets])
    return module.weights_to_stencils(weights, offsets, 2)


def _quadratic(weights):
    """A fitness with its minimum away from the full-weighting start."""
    target = np.linspace(-0.2, 0.4, len(weights))
    return float(np.sum((np.asarray(weights) - target) ** 2))


def test_cmaes_matches_reference():
    x0 = np.array([1.5, -0.5, 0.25, 2.0, 0.0])
    ours = intergrid_transfer.CMAES(x0, sigma=0.3, population_size=6, seed=4)
    theirs = jax_intergrid.CMAES(x0, sigma=0.3, population_size=6, seed=4)
    for _ in range(12):
        xs, ys = ours.ask(), theirs.ask()
        np.testing.assert_array_equal(xs, ys)
        ours.tell(xs, np.sum(xs**2, axis=1))
        theirs.tell(ys, np.sum(ys**2, axis=1))
        np.testing.assert_array_equal(ours.mean, theirs.mean)
        np.testing.assert_array_equal(ours.C, theirs.C)
        assert ours.sigma == theirs.sigma


@pytest.mark.parametrize("pre, post, omega", [(1, 1, 0.8), (2, 0, 1.1)])
def test_two_grid_expression_matches_reference(pre, post, omega):
    problem = poisson_2d(MIN_LEVEL, MAX_LEVEL, dtype=torch.float64)
    jax_problem = jax_poisson_2d(MIN_LEVEL, MAX_LEVEL)
    r, p = _fw_bilinear(intergrid_transfer, gallery)
    jr, jp = _fw_bilinear(jax_intergrid, jax_gallery)
    ours = intergrid_transfer.build_two_grid_expression(
        problem, r, p, pre_smoothing=pre, post_smoothing=post, omega=omega)
    theirs = jax_intergrid.build_two_grid_expression(
        jax_problem, jr, jp, pre_smoothing=pre, post_smoothing=post, omega=omega)
    assert canonical_string(ours) == jax_canonical_string(theirs)


def test_optimize_intergrid_weights_matches_reference_with_caller_fitness():
    problem = poisson_2d(MIN_LEVEL, MAX_LEVEL, dtype=torch.float64)
    jax_problem = jax_poisson_2d(MIN_LEVEL, MAX_LEVEL)
    r, p, best, history = intergrid_transfer.optimize_intergrid_weights(
        problem, generations=6, seed=2, evaluate=_quadratic)
    jr, jp, jbest, jhistory = jax_intergrid.optimize_intergrid_weights(
        jax_problem, generations=6, seed=2, evaluate=_quadratic)
    assert best == jbest and history == jhistory
    assert best < history[0]
    assert sorted(r.entries) == sorted(jr.entries)
    assert sorted(p.entries) == sorted(jp.entries)
    # The LFA default (models/lfa.py) scores the same weights as the reference's.
    r, p, best, history = intergrid_transfer.optimize_intergrid_weights(
        problem, generations=1, samples_per_axis=4)
    jr, jp, jbest, jhistory = jax_intergrid.optimize_intergrid_weights(
        jax_problem, generations=1, samples_per_axis=4)
    assert best == jbest and history == jhistory and 0.0 < best < 1.0
    assert sorted(r.entries) == sorted(jr.entries)


def test_port_scores_the_two_grid_correction():
    problem = poisson_2d(MIN_LEVEL, MAX_LEVEL, dtype=torch.float64)
    r, p = _fw_bilinear(intergrid_transfer, gallery)
    expression = intergrid_transfer.build_two_grid_expression(problem, r, p)
    generator = TorchProgramGenerator(problem, device="cpu", iteration_limit=100)
    t, rho, iterations = generator.generate_and_evaluate(expression, evaluation_samples=1)
    assert np.isfinite(t) and 0.0 < rho < 0.5 and iterations < 100
