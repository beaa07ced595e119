"""The group path's batch over a member axis, on the CPU.

`generate_and_evaluate_group` runs the members' float32 power iterations as
one batched loop: fields shaped (B, *grid), ω one row per member, every op
on the trailing grid axes, every red-black sweep one (plain, here) batched
sweep.  Inputs come from numpy seeds.

* Each op with a member axis against the same op called on each member and
  stacked: constant, variable and periodic stencils, the red-black masks of
  the lowering's masked half-sweeps, restriction and prolongation, the point
  and block smoothers, the dense and the CG coarse solves, norms and inner
  products.  Bit for bit.
* The plain sweep with members against per-member calls (bit for bit), and
  against the JAX package's sweep under `jax.vmap` over ω in interpret mode
  (atol 5e-5, tests/test_torch_rb_sweep.py's tolerance).
* The batched group against the port's own `generate_and_evaluate` per
  member, ρ and iterations bit for bit, one shared time per iteration: n =
  2, 5, 16 and 20 (buckets 2, 8, 16 and 16 + 4), through the VM and lowered
  from the IR, for 2D and 3D Poisson, variable coefficients and two-field
  elasticity in float32; and against the JAX package's group path on the
  same members within 2 % / ±1.
* Members that the power iteration decides inside a batch (∞, ρ ≥ 1, over
  the cap) leave their neighbours' results as they are.
* The one-by-one cases: float64, FAS, an outer solver and a member whose
  program differs, each counted under its reason in `group_fallbacks`; a
  group above the largest bucket counts as a split.
* A device fault in the batched loop sends the members one by one, as the
  reference does: each member is its own evaluation, no device failure is
  left counted, and the fault counts under `device_fault`.
* The batched loop's member blocks: run, bucket × the loop's blocks; used,
  each real member's own blocks, padding rows never.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.ops.pallas_kernels import (
    red_black_collective_jacobi_sweep as jax_rb_sweep)
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.stencils import constant as jax_constant
from evostencils_torch.backend.evaluation import (
    GROUP_BUCKETS, PowerLoop, TorchProgramGenerator, group_bucket)
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir import base, krylov as ir_krylov
from evostencils_torch.ops import coarse_solve, intergrid, krylov, rb_sweep, smoothers
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.problems import elasticity, fas, helmholtz, poisson
from evostencils_torch.stencils import constant, periodic
from tests.torch_parity import JAX, PORT, Side

INFINITY = 1e100
FIVE_POINT = constant.Stencil(
    (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0)))
NINE_POINT = constant.Stencil(
    (((0, 0), 8.0 / 3), ((1, 0), -1 / 3), ((-1, 0), -1 / 3), ((0, 1), -1 / 3), ((0, -1), -1 / 3),
     ((1, 1), -1 / 3), ((1, -1), -1 / 3), ((-1, 1), -1 / 3), ((-1, -1), -1 / 3)))
SEVEN_POINT = constant.Stencil(
    (((0, 0, 0), 6.0),) + tuple((o, -1.0) for o in (
        (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))))
FULL_WEIGHTING = constant.Stencil(tuple(
    ((i, j), (2 - abs(i)) * (2 - abs(j)) / 16.0) for i in (-1, 0, 1) for j in (-1, 0, 1)))
BILINEAR = constant.Stencil(tuple(
    ((i, j), (2 - abs(i)) * (2 - abs(j)) / 4.0) for i in (-1, 0, 1) for j in (-1, 0, 1)))


def _members(shape, seed, count=5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((count,) + tuple(shape)).astype(np.float32))


def _stacked(fn, *batches):
    """fn on each member of the batches, stacked back along the member axis."""
    out = [fn(*members) for members in zip(*batches)]
    if isinstance(out[0], tuple):
        return tuple(torch.stack(field) for field in zip(*out))
    return torch.stack(out)


def _assert_bitwise(got, expected):
    if isinstance(expected, tuple):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            _assert_bitwise(g, e)
        return
    assert got.shape == expected.shape and torch.equal(got, expected)


# ---- the ops --------------------------------------------------------------

@pytest.mark.parametrize("stencil, shape", [
    (FIVE_POINT, (15, 15)), (NINE_POINT, (31, 17)), (SEVEN_POINT, (7, 7, 7))],
    ids=["5-point", "9-point", "7-point-3d"])
def test_constant_stencil(stencil, shape):
    u = _members(shape, 1)
    _assert_bitwise(sops.apply_constant_stencil(u, stencil),
                    _stacked(lambda x: sops.apply_constant_stencil(x, stencil), u))


def test_variable_and_periodic_stencils():
    shape = (15, 15)
    offsets = tuple(off for off, _ in NINE_POINT.entries)
    rng = np.random.default_rng(2)
    planes = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in offsets]
    u = _members(shape, 3)
    _assert_bitwise(sops.apply_variable_stencil(u, offsets, planes),
                    _stacked(lambda x: sops.apply_variable_stencil(x, offsets, planes), u))
    cells = np.empty((2, 1), dtype=object)
    cells[0, 0], cells[1, 0] = FIVE_POINT, NINE_POINT
    stencil = periodic.PeriodicStencil(cells)
    _assert_bitwise(sops.apply_periodic_stencil(u, stencil),
                    _stacked(lambda x: sops.apply_periodic_stencil(x, stencil), u))


def test_masked_red_black_half_sweeps():
    """The lowering's masked two-colour step (the kernel's gate refuses
    the lowering with use_kernels=False), ω one per member."""
    problem = poisson.poisson_2d(2, 4, dtype=torch.float32)
    side = Side(PORT, problem)
    A = side.terminals[0].operator
    B = side.smoother_factory("collective")(A)
    lowering = CycleLowering(torch.float32, "cpu", use_kernels=False)
    u, f = _members((15, 15), 4), _members((15, 15), 5)
    omegas = torch.linspace(0.6, 1.4, 5)
    got = lowering._apply_smoothing((u,), (f,), B, A, "rb", sops.per_member(omegas, u))
    expected = _stacked(lambda x, y, w: lowering._apply_smoothing((x,), (y,), B, A, "rb", w),
                        u, f, omegas)
    _assert_bitwise(got, expected)


@pytest.mark.parametrize("shape, stencil, factor", [
    ((15, 15), FULL_WEIGHTING, (2, 2)),
    ((7, 7, 7), constant.Stencil((((0, 0, 0), 0.5), ((1, 0, 0), 0.25), ((-1, 0, 0), 0.25))),
     (2, 2, 2))], ids=["2d", "3d"])
def test_restrict_and_prolong(shape, stencil, factor):
    coarse_shape = tuple((n + 1) // 2 - 1 for n in shape)
    fine = _members(shape, 6)
    _assert_bitwise(intergrid.restrict(fine, stencil, coarse_shape, factor),
                    _stacked(lambda x: intergrid.restrict(x, stencil, coarse_shape, factor), fine))
    coarse = _members(coarse_shape, 7)
    prolongation = BILINEAR if len(shape) == 2 else stencil
    _assert_bitwise(
        intergrid.prolong(coarse, prolongation, shape, factor),
        _stacked(lambda x: intergrid.prolong(x, prolongation, shape, factor), coarse))


def test_point_smoothers():
    r = (_members((15, 15), 8), _members((15, 15), 9))
    inv_center = np.array([[0.3, -0.1], [0.05, 0.4]])
    plane = torch.from_numpy(np.random.default_rng(10).uniform(0.1, 1, (15, 15)).astype(np.float32))
    cases = [
        lambda *fields: smoothers.decoupled_jacobi_apply(fields, [0.25, plane]),
        lambda *fields: smoothers.collective_jacobi_apply(fields, inv_center),
        lambda *fields: smoothers.collective_jacobi_apply_variable(
            fields, [[plane, None], [None, plane]]),
    ]
    for apply in cases:
        _assert_bitwise(apply(*r), _stacked(apply, *r))


@pytest.mark.parametrize("block", [(2, 1), (1, 2), (2, 2), (3, 1), (2, 3), (4, 2), (1, 8)])
def test_block_smoother(block):
    """Both run-time forms of the block solve: the matmul form folds the
    members into its rows, the masked form shifts the grid axes."""
    spec = smoothers.build_block_solve_spec(
        [[NINE_POINT]], [block], (15, 15), torch.float32, "cpu")
    r = (_members((15, 15), 11),)
    for apply in (spec.apply_matmul, spec.apply_masked):
        _assert_bitwise(apply(r), _stacked(lambda x: apply((x,)), r[0]))


def test_dense_and_cg_coarse_solves():
    problem = poisson.poisson_2d(2, 4, dtype=torch.float32)
    side = Side(PORT, problem)
    coarse = side.terminals[-1].coarse_operator
    lowering = CycleLowering(torch.float32, "cpu")
    r = _members((3, 3), 12)
    for solver in (base.CoarseGridSolver("CGS", coarse, None),
                   base.CoarseGridSolver(
                       "CGS", coarse, ir_krylov.generate_conjugate_gradient(coarse, 6))):
        _assert_bitwise(lowering.cgs_apply(solver, (r,)),
                        _stacked(lambda x: lowering.cgs_apply(solver, (x,)), r))
    fine = side.terminals[0].operator
    apply_a = lambda state: lowering.system_apply(fine, state)  # noqa: E731
    rhs = _members((15, 15), 13)
    for solve in krylov.SOLVERS.values():
        _assert_bitwise(solve(apply_a, (rhs,), 5, members=True),
                        _stacked(lambda x: solve(apply_a, (x,), 5), rhs))


def test_norms_and_dots():
    for shape in ((63, 63), (15, 15, 15)):
        a, b = (_members(shape, 14, 4), _members(shape, 15, 4)), (
            _members(shape, 16, 4), _members(shape, 17, 4))
        _assert_bitwise(sops.l2_norm(a, members=True), _stacked(lambda x, y: sops.l2_norm((x, y)), *a))
        _assert_bitwise(sops.dot(a, b, members=True),
                        _stacked(lambda x, y, z, w: sops.dot((x, y), (z, w)), *a, *b))


# ---- the sweep ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(15, 15), (161, 96)], ids=["whole-array", "row-blocked"])
def test_plain_sweep_with_members(shape):
    u, f = _members(shape, 18, 4), _members(shape, 19, 4)
    omegas = torch.tensor([0.8, 1.0, 1.15, 1.3], dtype=torch.float32)
    got = rb_sweep.rb_sweep_reference(u, f, omegas, NINE_POINT)
    _assert_bitwise(got, _stacked(
        lambda x, y, w: rb_sweep.rb_sweep_reference(x, y, w, NINE_POINT), u, f, omegas))
    # The wrapper takes the plain version on the CPU, members or not.
    _assert_bitwise(rb_sweep.red_black_collective_jacobi_sweep(u, f, omegas, NINE_POINT), got)

    jax_stencil = jax_constant.Stencil(NINE_POINT.entries)

    def one(x, y, w):
        return jax_rb_sweep(x, y, w, jax_stencil)

    args = (jnp.asarray(u.numpy()), jnp.asarray(f.numpy()), jnp.asarray(omegas.numpy()))
    try:
        expected = jax.vmap(one)(*args)
    except NotImplementedError:
        # Pallas refuses to batch in interpret mode: the JAX sweep per member.
        expected = jnp.stack([one(*member) for member in zip(*args)])
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=5e-5)


def test_buckets():
    assert [group_bucket(n) for n in (1, 2, 3, 5, 8, 9, 16, 20)] == [2, 2, 4, 8, 8, 16, 16, 16]
    assert GROUP_BUCKETS == (2, 4, 8, 16)


# ---- the group ------------------------------------------------------------

def _variants(side, n, seed, omegas=(0.5, 1.3), **cycle):
    """n textbook V(2,1) cycles whose ω differ (seeded, inside `omegas`);
    `cycle`: Side.cycle's smoother options."""
    rng = np.random.default_rng(seed)
    return [side.cycle(2, 1, float(w), **cycle) for w in rng.uniform(*omegas, n)]


def _check_group(generator, members, lowered=False):
    if lowered:
        # Every member through the lowering, as a structure outside the VM.
        generator._vm_program = lambda expression: (None, None)
    timings = []
    timed = generator._time_per_iteration_ms
    generator._time_per_iteration_ms = lambda *args: timings.append(args) or timed(*args)
    batched = generator.batched_members
    group = generator.generate_and_evaluate_group(members, infinity=INFINITY,
                                                  evaluation_samples=1)
    generator._time_per_iteration_ms = timed
    singles = [generator.generate_and_evaluate(e, infinity=INFINITY, evaluation_samples=1)
               for e in members]
    assert [g[1:] for g in group] == [s[1:] for s in singles]
    assert generator.batched_members - batched == len(members)
    survivors = [t / it for t, _, it in group if t < INFINITY]
    assert survivors and len(timings) == math.ceil(len(members) / GROUP_BUCKETS[-1])
    assert len({round(t, 9) for t in survivors}) <= len(timings)
    return group


@pytest.mark.parametrize("n", [2, 5, 16, 20])
def test_group_through_the_vm_matches_single_evaluation(n):
    problem = poisson.poisson_2d(3, 5, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    _check_group(generator, _variants(Side(PORT, problem), n, n))
    assert generator.groups_batched == (2 if n > 16 else 1)
    assert generator.group_fallbacks == {**dict.fromkeys(generator.group_fallbacks, 0),
                                         "split": int(n > 16)}
    assert generator.vm_stats()["vm_misses"] == 0


@pytest.mark.parametrize("n", [5, 20])
def test_lowered_group_matches_single_evaluation(n):
    problem = poisson.poisson_2d(3, 5, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    _check_group(generator, _variants(Side(PORT, problem), n, 30 + n, kind=(2, 2)), lowered=True)
    assert generator.vm_stats()["vm_hits"] == 0


@pytest.mark.parametrize("family", ["poisson3d", "varcoeff", "elasticity"])
def test_group_of_each_family_matches_single_evaluation(family):
    if family == "poisson3d":
        problem = poisson.poisson_3d(2, 4, dtype=torch.float32)
    elif family == "varcoeff":
        problem = poisson.poisson_2d_variable(3, 5, dtype=torch.float32)
    else:
        problem = elasticity.linear_elasticity_2d(3, 5, dtype=torch.float32)
    side = Side(PORT, problem)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    _check_group(generator, _variants(side, 3, 40))
    # Lowered: single-colour smoothing, and decoupled Jacobi for two fields.
    kind = "decoupled" if family == "elasticity" else "collective"
    _check_group(generator, _variants(side, 2, 41, (0.5, 0.9), kind=kind, red_black=False),
                 lowered=True)


def test_group_matches_the_reference_group():
    """Five textbook V(2,1) members at levels 3-5 (bucket 8 here and in the
    JAX package's vmapped power iteration): ρ within 2 %, iterations ±1."""
    omegas = (0.7, 0.85, 1.0, 1.1, 1.25)
    port_side = Side(PORT, poisson.poisson_2d(3, 5, dtype=torch.float32))
    jax_side = Side(JAX, jax_poisson_2d(3, 5, dtype=jnp.float32))
    port = TorchProgramGenerator(port_side.problem, dtype=torch.float32, device="cpu")
    got = port.generate_and_evaluate_group([port_side.cycle(2, 1, w) for w in omegas],
                                           infinity=INFINITY, evaluation_samples=1)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    expected = reference.generate_and_evaluate_group(
        [jax_side.cycle(2, 1, w) for w in omegas], infinity=INFINITY, evaluation_samples=1)
    assert port.groups_batched == 1
    for (_, rho, it), (_, rho_ref, it_ref) in zip(got, expected):
        assert rho_ref < 1.0
        assert abs(rho - rho_ref) <= 0.02 * rho_ref, (rho, rho_ref)
        assert abs(it - it_ref) <= 1, (it, it_ref)


def test_members_decided_by_the_power_iteration_inside_a_batch():
    """V(1,0) with single-colour Jacobi: ∞ (ω of 1e15 overflows the error
    norm), ρ ≥ 1 (ω 1.95 amplifies the highest frequencies) and, on a
    capped generator, more iterations than the cap, among members that
    converge: every member as its own evaluation gives it."""
    problem = poisson.poisson_2d(3, 5, dtype=torch.float32)
    side = Side(PORT, problem)
    omegas = (0.6, 1e15, 0.7, 1.95, 0.8)
    members = [side.cycle(1, 0, w, red_black=False) for w in omegas]
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    group = _check_group(generator, members)
    assert group[1] == (INFINITY, INFINITY, INFINITY)
    assert group[3][0] == INFINITY and group[3][1] >= 1.0
    assert group[3][2] == generator.iteration_limit
    assert all(group[i][0] < INFINITY for i in (0, 2, 4))

    rates = sorted(group[i][2] for i in (0, 2, 4))
    capped = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu",
                                   iteration_limit=rates[1])
    group = _check_group(capped, members)
    over = [g for g in group if g[0] == INFINITY and g[1] < 1.0]
    assert over and all(it > rates[1] for _, _, it in over)


def _stub(generator):
    calls = []
    generator.generate_and_evaluate = lambda e, **kwargs: calls.append(e) or (1.0, 0.5, 2)
    return calls


def test_one_by_one_cases():
    """float64, FAS and an outer solver go one by one before anything is
    built; members whose programs differ fall back one by one."""
    cases = [
        poisson.poisson_2d(3, 5, dtype=torch.float64),
        fas.fas_2d(dtype=torch.float32),
        helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=torch.complex64),
    ]
    for problem, reason in zip(cases, ("dtype64", "fas", "outer")):
        generator = TorchProgramGenerator(problem, device="cpu")
        calls = _stub(generator)
        assert generator.generate_and_evaluate_group(["a", "b"]) == [(1.0, 0.5, 2)] * 2
        assert calls == ["a", "b"] and generator.groups == generator.groups_batched == 0
        assert generator.group_stats()["group_fallbacks"][reason] == 1

    problem = poisson.poisson_2d(3, 5, dtype=torch.float32)
    side = Side(PORT, problem)
    members = [side.cycle(2, 1, 0.9), side.cycle(1, 1, 0.9)]
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    calls = _stub(generator)
    assert len(generator.generate_and_evaluate_group(members)) == 2
    assert calls == members and generator.groups_batched == 0
    assert generator.group_fallbacks["program_differs"] == 1


def test_a_device_fault_in_the_batched_loop_sends_the_members_one_by_one(monkeypatch):
    problem = poisson.poisson_2d(3, 5, dtype=torch.float32)
    members = _variants(Side(PORT, problem), 5, 50)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    (_, power_solve, _), _ = generator._build_solver(members[0])

    def fault(*args):
        raise torch.cuda.OutOfMemoryError("a batch too large for the card")

    monkeypatch.setattr(power_solve, "batched", fault)
    group = generator.generate_and_evaluate_group(members, infinity=INFINITY,
                                                  evaluation_samples=1)
    assert generator._consecutive_device_failures == 0
    assert generator.group_fallbacks["device_fault"] == 1
    assert generator.groups == generator.groups_batched == 0
    singles = [generator.generate_and_evaluate(e, infinity=INFINITY, evaluation_samples=1)
               for e in members]
    assert [g[1:] for g in group] == [s[1:] for s in singles]
    assert all(t < INFINITY for t, _, _ in group + singles)


def test_member_blocks_run_and_used():
    """Five red-black V(2,1) members in bucket 8 that settle after 3 or 4
    blocks: the loop runs 4 blocks of 8 rows; the members use their own."""
    problem = poisson.poisson_2d(3, 5, dtype=torch.float32)
    side = Side(PORT, problem)
    members = [side.cycle(2, 1, w) for w in (0.15, 0.6, 1.0, 1.5, 1.85)]
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    generator.generate_and_evaluate_group(members, infinity=INFINITY, evaluation_samples=1)
    stats = generator.group_stats()
    own = []
    for e in members:
        generator.generate_and_evaluate(e, infinity=INFINITY, evaluation_samples=1)
        own.append(generator.last_cycle_solve["power_cycles"] // PowerLoop.BLOCK_LEN)
    assert len(set(own)) > 1
    assert stats["member_blocks_run"] == 8 * max(own)
    assert stats["member_blocks_used"] == sum(own)
