"""The port's Krylov solvers against the JAX reference on the CPU.

The same seeded numpy arrays go through `evostencils_tpu.ops.krylov` and
`evostencils_torch.ops.krylov`, each applying its own package's stencil.
Tolerances, all relative to the largest entry of the reference's result:

* fixed-count solvers (CG, CR, MinRes, BiCGStab), 1-8 iterations, float64
  and complex128, on a 2D Poisson operator at 15² and a complex-shifted
  Helmholtz operator at 31²: 1e-10.  Few iterations, so only the summation
  order differs.
* `preconditioned_bicgstab` with a damped-Jacobi preconditioner on Poisson
  at 15², stopping at a reduction of 1e-3 after 21 iterations: the same
  iteration count, x and the final residual norm within 1e-8 (measured
  4e-11 and 6e-9).  BiCGStab amplifies rounding from iteration to
  iteration: run on to 1e-7 (37 iterations) the counts still agree, but x
  parts by 5e-8 and the final norm, which is where the last step happens to
  land, by 19 % in complex128, so the tight comparison is made where the
  arithmetic is short.
* a V(2,2) two-grid cycle whose coarse solve is 40 CG iterations, built as
  tests/test_optimizer.py builds it, levels 4-5, float64, residual target
  1e-6: ρ within 1e-6 relative of the reference's (measured 3e-9; at the
  default target 1e-12 the last residuals of this ρ = 0.005 cycle sit at the
  float64 floor and the two ρ part by 3e-3, as tests/test_torch_slice.py
  says of its own fast cycles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import base as jax_base
from evostencils_tpu.ir import krylov as jax_ir_krylov
from evostencils_tpu.ir import partitioning as jax_part
from evostencils_tpu.ir import smoother as jax_smoother
from evostencils_tpu.ops import krylov as jax_krylov
from evostencils_tpu.ops import stencil_ops as jax_sops
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.stencils import gallery as jax_gallery
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import multigrid
from evostencils_torch.ir import base, partitioning, smoother
from evostencils_torch.ir import krylov as ir_krylov
from evostencils_torch.ops import krylov
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.problems.api import make_grid
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import gallery

SHORT = 1e-10
STOPPING = 1e-8
COARSE_RHO = 1e-6


def _operators(name):
    """(shape, apply_a for JAX, apply_a for torch, centre value) of the
    same operator built through each package's gallery."""
    if name == "poisson":
        level, make = 4, lambda g: g.Poisson2D()
    else:
        # The complex-shifted Helmholtz operator M at k = 20 on 31².
        level, make = 5, lambda g: g.Helmholtz2D(20.0, complex(1.0, 0.5))
    grid = make_grid(level, 2)
    jax_stencil = make(jax_gallery).generate_stencil(grid)
    stencil = make(gallery).generate_stencil(grid)

    def jax_apply(state):
        return tuple(jax_sops.apply_constant_stencil(x, jax_stencil) for x in state)

    def torch_apply(state):
        return tuple(sops.apply_constant_stencil(x, stencil) for x in state)

    return grid.interior_shape, jax_apply, torch_apply, stencil.center_value()


def _rhs(shape, np_dtype, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape)
    if np.issubdtype(np_dtype, np.complexfloating):
        f = f + 1j * rng.standard_normal(shape)
    return f.astype(np_dtype)


def _relative(got, expected):
    expected = np.asarray(expected)
    return float(np.abs(got.numpy() - expected).max() / np.abs(expected).max())


CASES = [
    (solver, operator, np_dtype, iterations)
    for solver, iterations in (("ConjugateGradient", 8), ("ConjugateResidual", 5),
                               ("MinRes", 3), ("BiCGStab", 6))
    for operator in ("poisson", "helmholtz")
    for np_dtype in (np.float64, np.complex128)
    # The shifted operator is complex: a real state has no such product.
    if not (operator == "helmholtz" and np_dtype == np.float64)
] + [("BiCGStab", "poisson", np.float64, 1), ("ConjugateGradient", "helmholtz", np.complex128, 1)]


@pytest.mark.parametrize(
    "solver,operator,np_dtype,iterations", CASES,
    ids=[f"{s}-{o}-{np.dtype(d).name}-{n}" for s, o, d, n in CASES])
def test_fixed_count_solver_matches_reference(solver, operator, np_dtype, iterations):
    shape, jax_apply, torch_apply, _ = _operators(operator)
    f = _rhs(shape, np_dtype, seed=len(solver) + iterations)
    expected = jax_krylov.SOLVERS[solver](jax_apply, (jnp.asarray(f),), iterations)[0]
    got = krylov.SOLVERS[solver](torch_apply, (torch.from_numpy(f),), iterations)[0]
    assert got.dtype == torch.from_numpy(f).dtype
    assert _relative(got, expected) <= SHORT


def test_solver_registry_is_the_reference_s():
    assert set(krylov.SOLVERS) == set(jax_krylov.SOLVERS)
    assert krylov._EPS == jax_krylov._EPS == 1e-30


@pytest.mark.parametrize("np_dtype", [np.float64, np.complex128])
def test_conjugate_gradient_with_initial_guess(np_dtype):
    shape, jax_apply, torch_apply, _ = _operators("poisson")
    f, x0 = _rhs(shape, np_dtype, seed=1), _rhs(shape, np_dtype, seed=2)
    expected = jax_krylov.conjugate_gradient(
        jax_apply, (jnp.asarray(f),), 6, x0=(jnp.asarray(x0),))[0]
    got = krylov.conjugate_gradient(
        torch_apply, (torch.from_numpy(f),), 6, x0=(torch.from_numpy(x0),))[0]
    assert _relative(got, expected) <= SHORT
    # The guess is used: from the exact solution no iteration moves it.
    solved = krylov.conjugate_gradient(torch_apply, (torch.from_numpy(f),), 200)
    again = krylov.conjugate_gradient(torch_apply, (torch.from_numpy(f),), 1, x0=solved)[0]
    assert _relative(again, solved[0].numpy()) <= 1e-9


def test_safe_div_at_a_zero_denominator():
    for dtype, np_dtype in ((torch.float64, np.float64), (torch.complex128, np.complex128)):
        a = torch.tensor(3.0, dtype=dtype)
        for b in (0.0, 1e-31, 2.0):
            expected = jax_krylov._safe_div(
                jnp.asarray(3.0, dtype=np_dtype), jnp.asarray(b, dtype=np_dtype))
            got = krylov._safe_div(a, torch.tensor(b, dtype=dtype))
            assert got.dtype == dtype
            np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-15)
    assert float(krylov._safe_div(torch.tensor(3.0), torch.tensor(0.0))) == pytest.approx(3e30)


def test_dot_conjugates_its_first_argument():
    x, y = _rhs((7, 5), np.complex128, 3), _rhs((7, 5), np.complex128, 4)
    state_x, state_y = (torch.from_numpy(x),) * 2, (torch.from_numpy(y), torch.from_numpy(x))
    expected = jax_sops.dot((jnp.asarray(x),) * 2, (jnp.asarray(y), jnp.asarray(x)))
    got = sops.dot(state_x, state_y)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-13)
    np.testing.assert_allclose(got.numpy(), np.vdot(x, y) + np.vdot(x, x), rtol=1e-13)
    assert abs(got.numpy() - (np.sum(x * np.conj(y)) + np.vdot(x, x))) > 1e-3
    norm = sops.l2_norm(state_x)
    assert norm.dtype == torch.float64
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jax_sops.l2_norm((jnp.asarray(x),) * 2)), rtol=1e-13)
    assert all(z.dtype == torch.complex128 and not z.any()
               for z in sops.zeros_like_state(state_x))


def test_complex_coefficient_keeps_its_imaginary_part():
    """A complex stencil entry times a complex tensor keeps the tensor's
    dtype and the entry's imaginary part; times a real tensor the product
    promotes to complex, as the reference's does, and is never truncated."""
    shape, jax_apply, torch_apply, center = _operators("helmholtz")
    assert abs(complex(center).imag) > 0
    assert sops.scalar(center) == complex(center) and sops.scalar(2 + 0j) == 2.0
    for np_dtype in (np.complex64, np.complex128, np.float32, np.float64):
        u = _rhs(shape, np_dtype, 5)
        expected = np.asarray(jax_apply((jnp.asarray(u),))[0])
        got = torch_apply((torch.from_numpy(u),))[0].numpy()
        assert got.dtype == expected.dtype and np.iscomplexobj(got)
        assert np.abs(got.imag).max() > 0
        np.testing.assert_allclose(
            got, expected, rtol=0, atol=(1e-4 if got.dtype == np.complex64 else 1e-12) * np.abs(expected).max())


def _jacobi(apply_a, center, weight=0.8):
    """apply_m: one damped-Jacobi sweep from zero, ω·D⁻¹·r."""
    return lambda state: tuple((weight / center) * x for x in state)


@pytest.mark.parametrize("np_dtype", [np.float64, np.complex128])
def test_preconditioned_bicgstab_stops_where_the_reference_stops(np_dtype):
    shape, jax_apply, torch_apply, center = _operators("poisson")
    f = _rhs(shape, np_dtype, seed=6)
    x_ref, it_ref, res_ref = jax_krylov.preconditioned_bicgstab(
        jax_apply, _jacobi(jax_apply, center), (jnp.asarray(f),), 200, 1e-3)
    x, it, res = krylov.preconditioned_bicgstab(
        torch_apply, _jacobi(torch_apply, center), (torch.from_numpy(f),), 200, 1e-3)
    assert 5 < it <= 30
    assert it == int(it_ref)
    assert _relative(x[0], x_ref[0]) <= STOPPING
    assert abs(res - float(res_ref)) <= STOPPING * float(res_ref)
    assert res <= 1e-3 * np.linalg.norm(f)


def test_preconditioned_bicgstab_hits_its_cap():
    shape, jax_apply, torch_apply, center = _operators("poisson")
    f = _rhs(shape, np.float64, seed=7)
    x_ref, it_ref, res_ref = jax_krylov.preconditioned_bicgstab(
        jax_apply, _jacobi(jax_apply, center), (jnp.asarray(f),), 4, 1e-7)
    x, it, res = krylov.preconditioned_bicgstab(
        torch_apply, _jacobi(torch_apply, center), (torch.from_numpy(f),), 4, 1e-7)
    assert it == int(it_ref) == 4
    assert _relative(x[0], x_ref[0]) <= SHORT
    assert abs(res - float(res_ref)) <= SHORT * float(res_ref)
    assert res > 1e-7 * np.linalg.norm(f)


def test_preconditioned_bicgstab_returns_the_best_iterate_on_a_breakdown():
    """A preconditioner that turns to NaN in its third application (the
    first of iteration 2): the loop ends on the non-finite residual and
    the iterate of iteration 1 comes back, with its residual norm."""
    shape, jax_apply, torch_apply, center = _operators("poisson")
    f = _rhs(shape, np.float64, seed=8)

    def breaking(jacobi, nan):
        calls = []

        def apply_m(state):
            calls.append(1)
            return jacobi(state) if len(calls) <= 2 else tuple(x * nan for x in state)

        return apply_m

    x1, _, res1 = krylov.preconditioned_bicgstab(
        torch_apply, _jacobi(torch_apply, center), (torch.from_numpy(f),), 1, 1e-7)
    x, it, res = krylov.preconditioned_bicgstab(
        torch_apply, breaking(_jacobi(torch_apply, center), float("nan")),
        (torch.from_numpy(f),), 50, 1e-7)
    assert it == 2
    assert torch.isfinite(x[0]).all()
    assert torch.equal(x[0], x1[0]) and res == res1
    # The reference's while_loop traces apply_m once, so its breakdown is a
    # preconditioner that is NaN from the start: both return the zero guess.
    x_ref, it_ref, res_ref = jax_krylov.preconditioned_bicgstab(
        jax_apply, lambda state: tuple(x * jnp.nan for x in state), (jnp.asarray(f),), 50, 1e-7)
    x0, it0, res0 = krylov.preconditioned_bicgstab(
        torch_apply, lambda state: tuple(x * float("nan") for x in state),
        (torch.from_numpy(f),), 50, 1e-7)
    assert it0 == int(it_ref) == 1
    assert not x0[0].any() and not np.asarray(x_ref[0]).any()
    assert res0 == pytest.approx(float(res_ref), rel=1e-14) == pytest.approx(np.linalg.norm(f))


def test_preconditioned_bicgstab_decides_in_the_state_s_precision():
    """complex64 and float32 states stop on float32 norms, as the
    reference's device loop does."""
    shape, _, torch_apply, center = _operators("poisson")
    for np_dtype in (np.float32, np.complex64):
        f = torch.from_numpy(_rhs(shape, np_dtype, seed=9))
        assert isinstance(krylov._residual_norm((f,)), np.float32)
        x, it, res = krylov.preconditioned_bicgstab(
            torch_apply, _jacobi(torch_apply, center), (f,), 200, 1e-4)
        assert x[0].dtype == f.dtype and 0 < it < 200 and isinstance(res, float)
    assert isinstance(krylov._residual_norm((f.to(torch.complex128),)), np.float64)


def _two_grid_with_cg(side_base, side_part, side_smoother, side_krylov, terminals, f, iterations):
    """tests/test_optimizer.py's V(2,2) two-grid cycle with red-black
    Jacobi smoothing, its coarse solve `iterations` of CG."""
    t0 = terminals[0]
    u, A = t0.approximation, t0.operator

    def smooth(ucur):
        for _ in range(2):
            corr = side_base.Multiplication(
                side_base.Inverse(side_smoother.generate_collective_jacobi(A)),
                side_base.Residual(A, ucur, f))
            ucur = side_base.Cycle(ucur, f, corr, partitioning=side_part.RedBlack,
                                   relaxation_factor=1.0)
        return ucur

    ucur = smooth(u)
    f_c = side_base.Multiplication(t0.restriction, side_base.Residual(A, ucur, f))
    cg = side_krylov.generate_conjugate_gradient(t0.coarse_operator, iterations)
    cgs = side_base.CoarseGridSolver("CGS", t0.coarse_operator, cg)
    corr = side_base.Multiplication(t0.prolongation, side_base.Multiplication(cgs, f_c))
    return smooth(side_base.Cycle(ucur, f, corr, relaxation_factor=1.0))


def _terminals(problem, grammar):
    return grammar.generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        5, problem.equations, problem.operators, problem.fields, depth=1,
        maximum_local_system_size=4)[1]


def test_krylov_coarse_grid_solver_matches_reference():
    jax_problem = jax_poisson_2d(min_level=4, max_level=5, dtype=jnp.float64)
    problem = poisson_2d(min_level=4, max_level=5, dtype=torch.float64)
    jax_cycle = _two_grid_with_cg(
        jax_base, jax_part, jax_smoother, jax_ir_krylov,
        _terminals(jax_problem, jax_multigrid), jax_problem.rhs(), 40)
    cycle = _two_grid_with_cg(
        base, partitioning, smoother, ir_krylov,
        _terminals(problem, multigrid), problem.rhs(), 40)
    reference = JaxProgramGenerator(jax_problem, dtype=jnp.float64, epsilon=1e-6)
    port = TorchProgramGenerator(problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    _, rho_ref, it_ref = reference.generate_and_evaluate(jax_cycle, evaluation_samples=1)
    _, rho, it = port.generate_and_evaluate(cycle, evaluation_samples=1)
    assert rho_ref < 0.1
    assert abs(rho - rho_ref) <= COARSE_RHO * rho_ref, (rho, rho_ref)
    assert it == it_ref
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses)
