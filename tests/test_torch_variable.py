"""The port's variable-coefficient path against the JAX reference on the CPU.

Variable-coefficient Poisson in 2D (levels 3-5, 31² finest, κ = 10) and 3D
(levels 2-4, 15³), and Helmholtz with Robin boundaries (complex
coefficient planes on the boundary rows).  Tolerances:

* `apply_variable_stencil` with the same planes carried across: 1e-12 in
  float64, 1e-6 relative in float32; the dense matrix from planes: exact;
* one cycle lowered on both sides: 1e-12 relative to max|u| (float64);
* fitness: float32 ρ within 1 %, iterations ±1 and the same infinities;
  float64 staged at ε = 1e-6, ρ within 1e-8 and equal iterations (the
  bands and their reasons are those of tests/test_torch_slice.py);
* the host residual: 1e-12;
* Robin: the planes exactly; the outer BiCGStab count within ±2 (the band
  of tests/test_torch_helmholtz.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.ir import base as jax_ir_base
from evostencils_tpu.ir import reference_cycles as jax_cycles
from evostencils_tpu.ops import coarse_solve as jax_coarse_solve
from evostencils_tpu.ops import stencil_ops as jax_sops
from evostencils_tpu.problems import helmholtz as jax_helmholtz
from evostencils_tpu.problems import poisson as jax_poisson
from evostencils_tpu.stencils import gallery as jax_gallery
from evostencils_torch import interop
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir import reference_cycles
from evostencils_torch.ops import coarse_solve, stencil_ops
from evostencils_torch.problems import helmholtz, poisson
from torch_parity import (
    INFINITY, JAX, JAX_DTYPES, PORT, Side, assert_close_relative, jax_state, seeded_trees,
)

GENERATORS = {
    2: (jax_gallery.Poisson2DVariableCoefficients, (32, 32), 5),
    3: (jax_gallery.Poisson3DVariableCoefficients, (16, 16, 16), 4),
}


def _jax_planes(dimension):
    cls, size, level = GENERATORS[dimension]
    grid = jax_ir_base.Grid(size, tuple(1.0 / s for s in size), level)
    return grid, cls().generate_coefficient_arrays(grid)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dimension", [2, 3])
def test_apply_variable_stencil_matches_reference(dimension, dtype):
    grid, (offsets, planes) = _jax_planes(dimension)
    u = np.random.default_rng(dimension).standard_normal(grid.interior_shape)
    jax_dtype = JAX_DTYPES[dtype]
    expected = np.asarray(jax_sops.apply_variable_stencil(
        jnp.asarray(u, jax_dtype), offsets,
        [jnp.asarray(np.asarray(p, np.dtype(jax_dtype))) for p in planes]))
    t_offsets, t_planes = interop.planes_to_torch((offsets, planes), "cpu", dtype)
    got = stencil_ops.apply_variable_stencil(
        torch.from_numpy(u).to(dtype), t_offsets, t_planes).numpy()
    scale = np.abs(expected).max()
    tolerance = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got / scale, expected / scale, rtol=0, atol=tolerance)
    # The host twin applies the generator's own float64 planes.
    host = stencil_ops.numpy_apply_variable_stencil(u, offsets, planes)
    reference64 = np.asarray(jax_sops.apply_variable_stencil(
        jnp.asarray(u), offsets, [jnp.asarray(p) for p in planes]))
    np.testing.assert_allclose(host / scale, reference64 / scale, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dimension", [2, 3])
def test_dense_matrix_from_planes_is_the_reference_matrix(dimension):
    cls, _, _ = GENERATORS[dimension]
    size = (8,) * dimension
    grid = jax_ir_base.Grid(size, tuple(1.0 / s for s in size), 3)
    planes = cls().generate_coefficient_arrays(grid)
    expected = jax_coarse_solve.assemble_scalar_matrix(None, grid.interior_shape, planes=planes)
    got = coarse_solve.assemble_scalar_matrix(None, grid.interior_shape, planes=planes)
    np.testing.assert_array_equal(got, expected)


def _sides(dtype, build=("poisson_2d_variable", 3, 5)):
    name, lo, hi = build
    return (Side(JAX, getattr(jax_poisson, name)(lo, hi, dtype=JAX_DTYPES[dtype])),
            Side(PORT, getattr(poisson, name)(lo, hi, dtype=dtype)))


def _one_cycle(jax_side, side, jax_cycle, cycle, seed):
    shapes = [g.interior_shape for g in side.problem.grid_at(side.problem.max_level)]
    rng = np.random.default_rng(seed)
    u0 = tuple(rng.standard_normal(s) for s in shapes)
    f = tuple(rng.standard_normal(s) for s in shapes)
    expected = JaxLowering(jnp.float64, use_pallas=False).lower(jax_cycle)(
        jax_state(u0, jnp.float64), jax_state(f, jnp.float64))
    got = CycleLowering(torch.float64, "cpu").lower(cycle)(
        interop.state_to_torch(u0, "cpu", torch.float64),
        interop.state_to_torch(f, "cpu", torch.float64))
    assert_close_relative(got, expected, 1e-12)


@pytest.mark.parametrize("kind", ["collective", "decoupled", (2, 2)])
def test_one_v21_cycle_matches_reference(kind):
    """Point smoothers from per-point inverse planes, the block smoother
    from the stencil sampled at the generator's position (the reference's
    rule), and the dense coarsest solve assembled from planes."""
    jax_side, side = _sides(torch.float64)
    _one_cycle(jax_side, side, jax_side.cycle(2, 1, 0.8, kind), side.cycle(2, 1, 0.8, kind), 3)


def test_one_3d_variable_cycle_matches_reference():
    jax_side, side = _sides(torch.float64, ("poisson_3d_variable", 2, 4))
    _one_cycle(jax_side, side, jax_side.cycle(2, 1, 0.8), side.cycle(2, 1, 0.8), 4)


def _trees():
    return seeded_trees(_sides(torch.float32)[1], seed=8, count=4)


def test_float32_fitness_matches_reference():
    jax_side, side = _sides(torch.float32)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    port = TorchProgramGenerator(side.problem, dtype=torch.float32, device="cpu")
    strings = _trees()
    pairs = [(jax_side.compile(s), side.compile(s)) for s in strings]
    pairs.append((jax_side.cycle(2, 1, 0.8), side.cycle(2, 1, 0.8)))
    finite = 0
    for je, te in pairs:
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
        assert (t >= INFINITY) == (t_ref >= INFINITY), (t, t_ref)
        if rho_ref < INFINITY:
            assert abs(rho - rho_ref) <= 1e-2 * rho_ref, (rho, rho_ref)
            assert abs(it - it_ref) <= 1, (it, it_ref)
        finite += t_ref < INFINITY
    assert finite >= 2
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses)


def test_float64_staged_fitness_matches_reference():
    jax_side, side = _sides(torch.float64)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, epsilon=1e-6)
    port = TorchProgramGenerator(side.problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    strings = _trees()
    pairs = [(jax_side.compile(s), side.compile(s)) for s in strings]
    pairs.append((jax_side.cycle(2, 1, 0.8, (2, 2)), side.cycle(2, 1, 0.8, (2, 2))))
    for je, te in pairs:
        _, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
        _, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
        assert abs(rho - rho_ref) <= 1e-8 * rho_ref, (rho, rho_ref)
        assert it == it_ref


@pytest.mark.parametrize("build", [("poisson_2d_variable", 3, 5), ("poisson_3d_variable", 2, 4)])
def test_host_residual_matches_reference(build):
    jax_side, side = _sides(torch.float64, build)
    shapes = [g.interior_shape for g in side.problem.grid_at(side.problem.max_level)]
    rng = np.random.default_rng(5)
    u = tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)
    f = tuple(rng.standard_normal(s) for s in shapes)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    port = TorchProgramGenerator(side.problem, dtype=torch.float32, device="cpu")
    expected = reference._host_residual(jax_side.problem.finest_operator(), u, f)
    got = port._host_residual(side.problem.finest_operator(), u, f)
    for g, e in zip(got, expected):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, np.asarray(e), rtol=1e-12, atol=1e-12 * np.abs(e).max())


def test_robin_helmholtz_matches_reference():
    """The reference's TestHelmholtzRobin (k = 10, levels 3-4, complex128,
    V(2,1) ω = 0.6 on the finest pair of levels) on both sides: M and the
    outer A are variable, with complex Robin rows."""
    jax_problem = jax_helmholtz.helmholtz_2d(
        min_level=3, max_level=4, k=10.0, boundary="robin", dtype=jnp.complex128)
    problem = helmholtz.helmholtz_2d(
        min_level=3, max_level=4, k=10.0, boundary="robin", dtype=torch.complex128)
    jax_gen = jax_problem.finest_operator().entries[0][0].stencil_generator
    gen = problem.finest_operator().entries[0][0].stencil_generator
    assert gen.is_variable()
    grid = problem.finest_grid[0]
    jax_grid = jax_problem.finest_grid[0]
    for mine, theirs in zip(gen.generate_coefficient_arrays(grid),
                            jax_gen.generate_coefficient_arrays(jax_grid)):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jax_side, side = Side(JAX, jax_problem, depth=1), Side(PORT, problem, depth=1)
    jax_cycle = jax_cycles.generate_v_cycle(
        [jax_side.terminals[0]], jax_problem.rhs(), pre_smoothing=2, post_smoothing=1, omega=0.6)
    cycle = reference_cycles.generate_v_cycle(
        [side.terminals[0]], problem.rhs(), pre_smoothing=2, post_smoothing=1, omega=0.6)
    t_ref, rho_ref, it_ref = JaxProgramGenerator(
        jax_problem, dtype=jnp.complex128).generate_and_evaluate(jax_cycle, evaluation_samples=1)
    t, rho, it = TorchProgramGenerator(
        problem, dtype=torch.complex128, device="cpu").generate_and_evaluate(
            cycle, evaluation_samples=1)
    assert t < 1e50 and t_ref < 1e50 and it < 500
    assert abs(it - it_ref) <= 2, (it, it_ref)
    assert rho < 1.0
