"""The port's nonlinear FAS path against the JAX reference on the CPU.

-Δu + γ·u·eᵘ = f (γ = 20), levels 3-5 (31² finest), the reference's FAS
tests (tests/test_problems.py, TestFAS) on both sides:

* the generator's nonlinear protocol: 1e-12;
* one Newton V(2,2) two-grid cycle (ω = 0.8, 200 damped Picard sweeps
  through exp on the coarse grid): 1e-10 relative to max|u| in float64;
* fitness (one residual-driven stage, no power iteration, no VM): float64
  ρ within 1e-6 and equal iterations, float32 ρ within 1 % and iterations
  ±1; 20 Newton cycles reach the manufactured solution within 5e-3;
* the FAS grammar (Newton and Picard smoothers, no block Jacobi) and four
  seeded trees scored on both sides within the same bands.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.ir import base as jax_ir_base
from evostencils_tpu.problems import fas as jax_fas
from evostencils_torch import interop
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir import base
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.problems import build_named_problem, fas
from torch_parity import (
    INFINITY, JAX, JAX_DTYPES, PORT, Side, assert_close_relative, jax_state, seeded_trees,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sides(dtype, depth=1):
    return (Side(JAX, jax_fas.fas_2d(3, 5, dtype=JAX_DTYPES[dtype]), depth=depth,
                 maximum_local_system_size=4),
            Side(PORT, fas.fas_2d(3, 5, dtype=dtype), depth=depth, maximum_local_system_size=4))


def _newton_v22(side):
    return side.cycle(2, 2, 0.8, "newton", levels=1)


def test_problem_matches_reference():
    jax_problem, problem = jax_fas.fas_2d(), fas.fas_2d()
    for key in ("name", "min_level", "max_level", "parameters", "uses_fas",
                "residual_target", "iteration_limit"):
        assert getattr(problem, key) == getattr(jax_problem, key), key
    named = build_named_problem("fas", 3, 5)
    assert (named.min_level, named.max_level, named.uses_fas) == (5, 9, True)
    expected = jax_fas.fas_2d(3, 5).rhs_arrays(jnp.float64, level=5, host=True)
    np.testing.assert_array_equal(fas.fas_2d(3, 5).rhs_arrays(torch.float64, level=5)[0],
                                  expected[0])


def test_nonlinear_generator_protocol_matches_reference():
    reference, generator = jax_fas.NonlinearLambdaExpGenerator(20.0), \
        fas.NonlinearLambdaExpGenerator(20.0)
    u = np.random.default_rng(2).uniform(-1.0, 1.0, (15, 15))
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    grid, jax_grid = base.Grid((16, 16), (1 / 16, 1 / 16), 4), \
        jax_ir_base.Grid((16, 16), (1 / 16, 1 / 16), 4)
    for name in ("nonlinear_term", "derivative_diag"):
        np.testing.assert_allclose(getattr(generator, name)(tu).numpy(),
                                   np.asarray(getattr(reference, name)(ju)), rtol=1e-12)
    np.testing.assert_allclose(generator.apply(tu, grid).numpy(),
                               np.asarray(reference.apply(ju, jax_grid)), rtol=1e-12, atol=1e-9)
    assert generator.linear_center(grid) == reference.linear_center(jax_grid)
    assert sorted(generator.generate_stencil(grid).entries) == sorted(
        reference.generate_stencil(jax_grid).entries)
    assert generator.is_nonlinear and not generator.is_variable()


@pytest.mark.parametrize("kind", ["newton", "picard"])
def test_one_cycle_matches_reference(kind):
    jax_side, side = _sides(torch.float64)
    rng = np.random.default_rng(13)
    u0 = (0.1 * rng.standard_normal((31, 31)),)
    f = side.problem.rhs_arrays(torch.float64)
    expected = JaxLowering(jnp.float64, use_pallas=False).lower(
        jax_side.cycle(2, 2, 0.8, kind, levels=1))(
            jax_state(u0, jnp.float64), jax_state(f, jnp.float64))
    got = CycleLowering(torch.float64, "cpu").lower(side.cycle(2, 2, 0.8, kind, levels=1))(
        interop.state_to_torch(u0, "cpu", torch.float64),
        interop.state_to_torch(f, "cpu", torch.float64))
    assert_close_relative(got, expected, 1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fitness_matches_reference(dtype):
    jax_side, side = _sides(dtype)
    reference = JaxProgramGenerator(jax_side.problem, dtype=JAX_DTYPES[dtype])
    port = TorchProgramGenerator(side.problem, dtype=dtype, device="cpu")
    for kind in ("newton", "picard"):
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
            jax_side.cycle(2, 2, 0.8, kind, levels=1), evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(
            side.cycle(2, 2, 0.8, kind, levels=1), evaluation_samples=1)
        assert t < INFINITY and t_ref < INFINITY
        if dtype == torch.float64:
            assert abs(rho - rho_ref) <= 1e-6 * rho_ref and it == it_ref, (rho, rho_ref, it, it_ref)
        else:
            assert abs(rho - rho_ref) <= 1e-2 * rho_ref and abs(it - it_ref) <= 1
        if kind == "newton":
            # The reference's test_newton_two_grid_converges_fast.
            assert rho < 0.1 and it < 15
    # FAS takes neither the VM nor the power iteration, on both sides.
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses) == (0, 2)


def test_newton_cycles_reach_the_manufactured_solution():
    _, side = _sides(torch.float64)
    step = CycleLowering(torch.float64, "cpu").lower(_newton_v22(side))
    u, f = side.problem.initial_state(torch.float64, device="cpu")
    for _ in range(20):
        u = step(u, f)
    x, y = side.problem.interior_coordinates(5)
    assert np.max(np.abs(u[0].numpy() - fas._solution(x, y))) < 5e-3


def test_fas_grammar_and_seeded_trees_match_reference():
    jax_side, side = _sides(torch.float64, depth=2)
    names = set(side.pset.mapping)
    assert names == set(jax_side.pset.mapping)
    assert any(n.startswith("jacobi_newton_0") for n in names)
    assert any(n.startswith("jacobi_picard_0") for n in names)
    assert not any(n.startswith("collective_block_jacobi") for n in names)
    rng = random.Random(1234)
    strings = [str(side.package.gp.gen_grow(side.pset, 2, 10, rng=rng)) for _ in range(4)]
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64)
    port = TorchProgramGenerator(side.problem, dtype=torch.float64, device="cpu")
    for s in strings:
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
            jax_side.compile(s), evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(side.compile(s), evaluation_samples=1)
        assert rho > 0 and (t >= INFINITY) == (t_ref >= INFINITY)
        if rho_ref < INFINITY:
            assert abs(rho - rho_ref) <= 1e-6 * rho_ref and it == it_ref, (s, rho, rho_ref)


@pytest.mark.slow
def test_protocol_champion_on_the_port():
    """The reference's test_protocol_champion_regression on the port: the
    stored FAS champion at levels 5-9 (511²) in float64.  A few seconds on
    an idle CPU, but 200 s beside other test processes (511² float64
    arrays), so it is slow."""
    with open(os.path.join(ROOT, "artifacts", "fas_champion_r5.txt")) as f:
        champion = "".join(line for line in f if not line.startswith("#")).strip()
    problem = fas.fas_2d(min_level=5, max_level=9, dtype=torch.float64)
    generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    optimizer = Optimizer.for_problem(problem, program_generator=generator, rng=random.Random(0))
    _, rho, iterations = optimizer.generate_and_evaluate_program_from_grammar_representation(
        champion, 8, evaluation_samples=1)
    assert rho < 0.25 and iterations <= 16, (rho, iterations)
