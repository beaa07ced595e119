"""The staged solves' host verdict (backend/device_solve.py,
backend/evaluation.py `_host_residual`, ops/stencil_ops.py) against its
earlier form, kept here as the oracle:

* the constant-stencil apply without a padded copy gives the zero-padded
  sum to the bit (2D 5- and 9-point, 3D 7-point, a first entry off the
  centre, float64 and complex128, odd and even shapes, zeros of both signs
  in the field), into a fresh array;
* `_host_residual` gives the earlier residual to the bit on one field and
  on two (elasticity), real and complex, and counts its route;
* the one host norm agrees with sqrt(Σ|x|²) to 1e-14 relative;
* one predicted solver, two right-hand sides: the iterate the first verdict
  judged is untouched by the second solve, and each solve's (cycles,
  stages) equal, and its rel lies within 1e-14 of, the solver's with the
  earlier apply and norm put back.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from evostencils_torch.backend import device_solve
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir import base, reference_cycles
from evostencils_torch.ops import stencil_ops
from evostencils_torch.problems import build_named_problem, poisson
from evostencils_torch.stencils import constant, periodic
from evostencils_torch.utils import profiling
from torch_parity import PORT, Side

TARGET = 1e-10


# ---- the earlier verdict, the oracle --------------------------------------

def padded_apply(u, stencil):
    """ops/stencil_ops.py's `numpy_apply_constant_stencil` on a zero-padded
    copy."""
    if stencil.number_of_entries == 0:
        return np.zeros_like(u)
    reach = stencil.max_reach()
    padded = np.pad(u, [(r, r) for r in reach])
    out = np.zeros_like(u)
    for offset, value in stencil.entries:
        index = tuple(slice(r + o, r + o + n) for r, o, n in zip(reach, offset, u.shape))
        out += value * padded[index]
    return out


def padded_residual(operator, u_fields, f_fields):
    """`_host_residual` on the padded apply, for constant entries."""
    out = []
    for i, row in enumerate(operator.entries):
        acc = np.array(f_fields[i],
                       dtype=np.complex128 if np.iscomplexobj(f_fields[i]) else np.float64)
        for entry, u in zip(row, u_fields):
            if isinstance(entry, base.ZeroOperator):
                continue
            stencil = entry.generate_stencil()
            if isinstance(stencil, periodic.PeriodicStencil):
                stencil = stencil.as_constant()
            acc -= padded_apply(np.asarray(u, acc.dtype), stencil)
        out.append(acc)
    return out


def earlier_norm(state):
    return float(np.sqrt(sum(np.sum(np.abs(np.asarray(x)) ** 2) for x in state)))


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def field(shape, dtype, seed):
    """A random field with zeros of both signs in it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal(shape)
    x = x.astype(dtype)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    return x


# ---- the constant-stencil apply -------------------------------------------

def _stencil(name, dtype):
    h2 = 1024.0
    centre = 4.0 * h2 if dtype == np.float64 else complex(4.0 * h2, -0.78 * h2)
    entries = {
        "five_point": [((-1, 0), -h2), ((0, -1), -h2), ((0, 0), centre), ((0, 1), -h2),
                       ((1, 0), -h2)],
        "nine_point": [((i, j), -h2 if (i, j) != (0, 0) else 2 * centre)
                       for i in (-1, 0, 1) for j in (-1, 0, 1)],
        "seven_point": [((0, 0, 0), 1.5 * centre)] + [
            (tuple(s if a == axis else 0 for a in range(3)), -h2)
            for axis in range(3) for s in (-1, 1)],
        "reach_two": [((1, -2), -0.75 * h2), ((0, 0), centre), ((-2, 1), -0.5 * h2),
                      ((0, 1), 0.25)],
        "centre_first": [((0, 0), centre), ((0, 2), -0.5 * h2), ((1, -1), -0.75 * h2),
                         ((2, 1), 0.25)],
    }[name]
    return constant.Stencil(entries)


SHAPES = {2: {"odd": (15, 15), "even": (16, 10)}, 3: {"odd": (7, 9, 7), "even": (8, 6, 4)}}


@pytest.fixture(params=[None, 3, 1], ids=["one_block", "blocks_of_3_rows", "blocks_of_1_row"])
def block_rows(request):
    """The host apply's blocks of leading rows: the whole of these small
    grids at the default size, else blocks of a few rows (an entry then
    reads rows of a neighbouring block)."""
    return request.param


def _block_bytes(rows, u):
    return rows * u[:1].nbytes if rows else stencil_ops._HOST_BLOCK_BYTES


@pytest.mark.parametrize("parity", ["odd", "even"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["float64", "complex128"])
@pytest.mark.parametrize(
    "name", ["five_point", "nine_point", "seven_point", "reach_two", "centre_first"])
def test_pad_free_apply_is_the_padded_sum_to_the_bit(name, dtype, parity, block_rows,
                                                     monkeypatch):
    """Entries go in their sorted order: every stencil here but
    `centre_first` starts off the centre."""
    stencil = _stencil(name, dtype)
    u = field(SHAPES[stencil.dimension][parity], dtype, seed=len(name))
    f = field(u.shape, dtype, seed=99)
    monkeypatch.setattr(stencil_ops, "_HOST_BLOCK_BYTES", _block_bytes(block_rows, u))
    got = stencil_ops.numpy_apply_constant_stencil(u, stencil)
    assert same_bits(got, padded_apply(u, stencil))
    again = stencil_ops.numpy_apply_constant_stencil(u, stencil)
    assert not np.shares_memory(got, again) and not np.shares_memory(got, u)
    assert same_bits(got, again)
    residual = stencil_ops.numpy_constant_residual(f, u, stencil)
    assert same_bits(residual, f - padded_apply(u, stencil))
    assert not np.shares_memory(residual, f) and not np.shares_memory(residual, u)


def test_pad_free_apply_of_an_empty_or_wider_stencil(block_rows, monkeypatch):
    """Offsets that reach past some blocks or past the grid (16 rows)."""
    u = field((16, 4), np.float64, seed=1)
    monkeypatch.setattr(stencil_ops, "_HOST_BLOCK_BYTES", _block_bytes(block_rows, u))
    empty = constant.Stencil([], dimension=2)
    assert same_bits(stencil_ops.numpy_apply_constant_stencil(u, empty), np.zeros_like(u))
    for entries in ([((6, 0), 2.0), ((0, 0), -3.0), ((0, -4), 1.5)],
                    [((-6, 1), 2.0), ((0, 5), -3.0), ((1, -1), 1.5)],
                    [((-6, 0), 2.0), ((0, 9), 1.0), ((17, 0), 4.0)]):
        wide = constant.Stencil(entries)
        assert same_bits(stencil_ops.numpy_apply_constant_stencil(u, wide),
                         padded_apply(u, wide)), entries


# ---- the host residual ------------------------------------------------------

def _problem(name):
    if name == "poisson3d":
        return poisson.poisson_3d(2, 4)
    return build_named_problem(name, 3, 5)


def _residual_case(name):
    problem = _problem(name)
    complex_ = name == "helmholtz"
    generator = TorchProgramGenerator(
        problem, dtype=torch.complex128 if complex_ else torch.float64, device="cpu")
    operator = problem.finest_operator()
    shapes = [tuple(np.shape(x)) for x in problem.initial_state(generator.dtype)[0]]
    dtype = np.complex128 if complex_ else np.float64
    u = tuple(field(s, dtype, seed=10 + i) for i, s in enumerate(shapes))
    f = tuple(field(s, dtype, seed=20 + i) for i, s in enumerate(shapes))
    return generator, operator, u, f


@pytest.mark.parametrize("name", ["poisson2d", "poisson3d", "elasticity", "helmholtz"])
def test_host_residual_is_the_earlier_residual_to_the_bit(name, block_rows, monkeypatch):
    generator, operator, u, f = _residual_case(name)
    monkeypatch.setattr(stencil_ops, "_HOST_BLOCK_BYTES", _block_bytes(block_rows, u[0]))
    expected = padded_residual(operator, u, f)
    got = generator._host_residual(operator, u, f)
    assert len(got) == len(expected) == len(u)
    for a, b, x in zip(got, expected, f):
        assert same_bits(a, b)
        assert not np.shares_memory(a, x)


@pytest.mark.parametrize("name, route", [("poisson2d", "host_residual.lean"),
                                         ("elasticity", "host_residual.lean"),
                                         ("poisson2d_var", "host_residual.numpy")])
def test_host_residual_counts_its_route_while_a_profiler_runs(name, route):
    generator, operator, u, f = _residual_case(name)
    profiling.take()
    generator._host_residual(operator, u, f)
    assert profiling.take().timed == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            generator._host_residual(operator, u, f)
    timed = profiling.take().timed
    assert set(timed) == {route} and timed[route][1] == 3 and timed[route][0] > 0


# ---- the one host norm ------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["float64", "complex128"])
@pytest.mark.parametrize("shapes", [[(63, 63)], [(255, 255), (255, 255)], [(31, 31, 31)]],
                         ids=["one", "two", "3d"])
def test_host_norm_agrees_with_the_earlier_formula(dtype, shapes):
    state = tuple(field(s, dtype, seed=30 + i) * 10.0 ** (3 * i) for i, s in enumerate(shapes))
    expected = earlier_norm(state)
    assert stencil_ops.numpy_l2_norm(state) == pytest.approx(expected, rel=1e-14, abs=0)
    assert stencil_ops.numpy_l2_norm(tuple(np.zeros_like(x) for x in state)) == 0.0


# ---- one predicted solver, two right-hand sides ----------------------------

class _Judged:
    """The generator as a staged solver sees it, keeping every iterate its
    verdicts judged."""

    def __init__(self, generator):
        self.generator = generator
        self.judged = []

    def _host_residual(self, operator, u_fields, f_fields):
        self.judged.append(u_fields)
        return self.generator._host_residual(operator, u_fields, f_fields)


@pytest.fixture(scope="module")
def predicted():
    """The V(2,2) predicted solver on 2D Poisson at 63², float32 cycles,
    and two right-hand sides."""
    problem = poisson.poisson_2d(3, 6, dtype=torch.float32)
    side = Side(PORT, problem)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    expression = reference_cycles.generate_v_cycle(side.terminals, problem.rhs(), 2, 2)
    rho = float(generator.generate_and_evaluate(expression, evaluation_samples=1)[1])
    _, f0 = problem.initial_state(torch.float32)
    first = tuple(np.asarray(x, np.float64) for x in f0)
    rng = np.random.default_rng(5)
    second = tuple(rng.standard_normal(x.shape).astype(np.float32).astype(np.float64)
                   for x in first)

    def build():
        judged = _Judged(generator)
        solve, _ = device_solve.staged_solver_for_expression(
            CycleLowering(torch.float32, "cpu"), expression, side.terminals[0].operator,
            problem, judged, lowering64=CycleLowering(torch.float64, "cpu", use_kernels=False),
            rho=rho, target=TARGET)

        def run(f64):
            return solve(tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in f64), f64)
        return run, judged

    return build, (first, second)


def test_a_judged_iterate_outlives_the_next_solve(predicted):
    build, rhs = predicted
    run, judged = build()
    first = run(rhs[0])
    kept = judged.judged[-1]
    copies = tuple(np.array(x, copy=True) for x in kept)
    second = run(rhs[1])
    latest = judged.judged[-1]
    assert first[1] <= TARGET and second[1] <= TARGET
    assert all(same_bits(x, c) for x, c in zip(kept, copies))
    assert not any(np.shares_memory(a, b) for a in kept for b in latest)


def test_two_solves_match_the_earlier_apply_and_norm(predicted, monkeypatch):
    build, rhs = predicted
    run, _ = build()
    got = [run(f) for f in rhs]
    with monkeypatch.context() as patch:
        patch.setattr(stencil_ops, "numpy_apply_constant_stencil", padded_apply)
        patch.setattr(stencil_ops, "numpy_constant_residual",
                      lambda f, u, stencil: np.array(f, u.dtype) - padded_apply(u, stencil))
        patch.setattr(device_solve, "numpy_l2_norm", earlier_norm)
        run, _ = build()
        expected = [run(f) for f in rhs]
    for (cycles, rel, stages), (e_cycles, e_rel, e_stages) in zip(got, expected):
        assert (cycles, stages) == (e_cycles, e_stages)
        assert rel == pytest.approx(e_rel, rel=1e-14, abs=0)
        assert rel <= TARGET


def test_a_staged_solve_takes_the_lean_route(predicted):
    build, rhs = predicted
    run, judged = build()
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        run(rhs[0])
    timed = profiling.take().timed
    assert timed.get("host_residual.lean", [0, 0])[1] == len(judged.judged) >= 1
    assert "host_residual.numpy" not in timed
