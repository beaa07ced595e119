"""The port's linear elasticity path (two coupled fields) against the JAX
reference on the CPU.

The reference's own elasticity tests (tests/test_problems.py, TestElasticity)
run on both sides at levels 3-5 in float64 and must give the same numbers:
one cycle to 1e-12 relative to max|u|, ρ within 1e-8 and equal iteration
counts at ε = 1e-6 (the band of tests/test_torch_slice.py).  The cycle VM
numbers a two-field tree's instructions as the reference's VM does (its
decoupled smoothers included), and the right-hand sides are equal.

The last test explains a record of the reference: its float32 statistics
give the tuned elasticity champion ρ 1e-16 in 1 iteration
(artifacts/secondary_r3/elasticity_stats_n20.json), where float64 gives
0.0160 in 7.  Both packages measure that champion alike in float32 today;
the record came from the power iteration before the reference renormalised
every cycle, whose 10-cycle block norm underflows float32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.backend.vm import CycleVM as JaxVM
from evostencils_tpu.ops import stencil_ops as jax_sops
from evostencils_tpu.problems import build_named_problem as jax_build_named_problem
from evostencils_tpu.problems import elasticity as jax_elasticity
from evostencils_tpu.utils.champions import apply_stored_omegas as jax_apply_stored_omegas
from evostencils_torch import interop
from evostencils_torch.backend.evaluation import ZERO_RATE_CLAMP, TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import CycleVM
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.problems import build_named_problem, elasticity
from evostencils_torch.stencils import periodic
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from torch_parity import (
    INFINITY, JAX, JAX_DTYPES, PORT, Side, assert_close_relative, jax_state, seeded_trees,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNED_CHAMPION = os.path.join(
    ROOT, "artifacts", "secondary_r3", "elasticity_individual_0_tuned.txt")


def _sides(dtype, min_level=3, max_level=5, depth=None):
    return (
        Side(JAX, jax_elasticity.linear_elasticity_2d(
            min_level, max_level, dtype=JAX_DTYPES[dtype]), depth=depth),
        Side(PORT, elasticity.linear_elasticity_2d(min_level, max_level, dtype=dtype),
             depth=depth),
    )


def _generators(jax_side, side, dtype, **kwargs):
    return (JaxProgramGenerator(jax_side.problem, dtype=JAX_DTYPES[dtype], **kwargs),
            TorchProgramGenerator(side.problem, dtype=dtype, device="cpu", **kwargs))


def _assert_staged_parity(pairs, reference, port):
    results = []
    for je, te in pairs:
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
        assert (t >= INFINITY) == (t_ref >= INFINITY), (t, t_ref)
        if rho_ref < INFINITY:
            assert abs(rho - rho_ref) <= 1e-8 * rho_ref, (rho, rho_ref)
            assert it == it_ref, (it, it_ref)
        results.append((t, rho, it))
    return results


def test_problem_and_rhs_match_reference():
    jax_problem = jax_elasticity.linear_elasticity_2d(3, 5)
    problem = elasticity.linear_elasticity_2d(3, 5)
    assert (problem.name, problem.fields, problem.constants) == (
        jax_problem.name, jax_problem.fields, jax_problem.constants)
    for level in (3, 5):
        for dtype in (torch.float32, torch.float64):
            expected = jax_problem.rhs_arrays(JAX_DTYPES[dtype], level=level, host=True)
            got = problem.rhs_arrays(dtype, level=level)
            for e, g in zip(expected, got):
                assert g.dtype == e.dtype
                np.testing.assert_array_equal(g, e)
    named = build_named_problem("elasticity", 5, 9)
    assert (named.name, named.min_level, named.max_level) == ("2D_FD_LinearElasticity", 5, 8)


def test_system_operator_block_structure():
    """The reference's block-structure test, and every entry's stencil
    equal to the reference's."""
    jax_side, side = _sides(torch.float64)
    A, A_ref = side.problem.finest_operator(), jax_side.problem.finest_operator()
    assert len(A.entries) == 2 and len(A.entries[0]) == 2
    s01, s10 = A.entries[0][1].generate_stencil(), A.entries[1][0].generate_stencil()
    assert periodic.lift(s01).as_constant() == periodic.lift(s10).as_constant()
    for row, row_ref in zip(A.entries, A_ref.entries):
        for entry, entry_ref in zip(row, row_ref):
            got = periodic.lift(entry.generate_stencil()).as_constant()
            expected = entry_ref.generate_stencil()
            assert sorted(got.entries) == sorted(
                (tuple(o), v) for o, v in periodic_constant_entries(expected))


def periodic_constant_entries(stencil):
    from evostencils_tpu.stencils import periodic as jax_periodic

    return jax_periodic.lift(stencil).as_constant().entries


@pytest.mark.parametrize("kind", ["collective", "decoupled", (1, 2)])
def test_one_cycle_matches_reference(kind):
    jax_side, side = _sides(torch.float64)
    rng = np.random.default_rng(21)
    u0 = tuple(rng.standard_normal((31, 31)) for _ in range(2))
    f = tuple(rng.standard_normal((31, 31)) for _ in range(2))
    expected = JaxLowering(jnp.float64, use_pallas=False).lower(jax_side.cycle(2, 2, 0.8, kind))(
        jax_state(u0, jnp.float64), jax_state(f, jnp.float64))
    got = CycleLowering(torch.float64, "cpu").lower(side.cycle(2, 2, 0.8, kind))(
        interop.state_to_torch(u0, "cpu", torch.float64),
        interop.state_to_torch(f, "cpu", torch.float64))
    assert_close_relative(got, expected, 1e-12)


def test_two_grid_converges_as_the_reference():
    """The reference's test_two_grid_converges: V(2,2) two-grid, ω = 0.8."""
    jax_side, side = _sides(torch.float64, depth=1)
    from evostencils_tpu.ir import reference_cycles as jax_cycles
    from evostencils_torch.ir import reference_cycles

    pairs = [(jax_cycles.generate_v_22_cycle_two_grid(
                  jax_side.terminals[0], jax_side.problem.rhs(), omega=0.8),
              reference_cycles.generate_v_22_cycle_two_grid(
                  side.terminals[0], side.problem.rhs(), omega=0.8))]
    reference, port = _generators(jax_side, side, torch.float64, epsilon=1e-6)
    ((_, rho, iterations),) = _assert_staged_parity(pairs, reference, port)
    assert rho < 0.5 and iterations < 100


def test_decoupled_and_collective_smoothers_as_the_reference():
    """The reference's test_decoupled_vs_collective_smoother: two red-black
    sweeps of either smoother around an exact two-grid correction."""
    jax_side, side = _sides(torch.float64, depth=1)
    pairs = [(jax_side.cycle(2, 0, 0.8, kind, levels=1), side.cycle(2, 0, 0.8, kind, levels=1))
             for kind in ("decoupled", "collective")]
    reference, port = _generators(jax_side, side, torch.float64, epsilon=1e-6)
    results = _assert_staged_parity(pairs, reference, port)
    assert all(rho < 1.0 for _, rho, _ in results)


def test_staged_fitness_of_seeded_trees_matches_reference():
    jax_side, side = _sides(torch.float64, depth=2)
    strings = seeded_trees(side, seed=4, count=4)
    pairs = [(jax_side.compile(s), side.compile(s)) for s in strings]
    reference, port = _generators(jax_side, side, torch.float64, epsilon=1e-6)
    results = _assert_staged_parity(pairs, reference, port)
    assert sum(t < INFINITY for t, _, _ in results) >= 1
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses)


def test_vm_opcodes_match_reference():
    jax_side, side = _sides(torch.float64, depth=2)
    jax_vm = JaxVM(JaxLowering(jnp.float64, use_pallas=False), jax_side.problem, 5)
    port_vm = CycleVM(CycleLowering(torch.float64, "cpu"), side.problem, 5)
    assert len(port_vm._branches) == len(jax_vm._branches)
    cycles = [(jax_side.compile(s), side.compile(s)) for s in seeded_trees(side, 4, 4)]
    cycles += [(jax_side.cycle(2, 1, 0.8, kind), side.cycle(2, 1, 0.8, kind))
               for kind in ("collective", "decoupled")]
    translated = 0
    for je, te in cycles:
        jax_program, program = jax_vm.translate(je), port_vm.translate(te)
        assert (jax_program is None) == (program is None)
        if program is not None:
            np.testing.assert_array_equal(
                interop.program_from_reference(jax_program).opcodes, program.opcodes)
            translated += 1
    assert translated >= 3


def _tuned_champion(min_level, max_level):
    jax_side = Side(JAX, jax_build_named_problem("elasticity", min_level, max_level))
    side = Side(PORT, build_named_problem("elasticity", min_level, max_level))
    tree, omegas = parse_champion_file(TUNED_CHAMPION)
    je, te = jax_side.compile(tree), side.compile(tree)
    assert jax_apply_stored_omegas(je, omegas, label="test") and apply_stored_omegas(
        te, omegas, label="test")
    reference, port = _generators(jax_side, side, torch.float32)
    return je, te, reference, port


def _assert_float32_fitness_of_the_tuned_champion(je, te, reference, port):
    _, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
    _, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
    assert 0.01 < rho_ref < 0.03 and abs(rho - rho_ref) <= 1e-2 * rho_ref
    assert abs(it - it_ref) <= 1 and it_ref == 8


def test_float32_fitness_of_the_tuned_champion_matches_reference():
    """Levels 3-6 (63²): today both packages measure the tuned champion in
    float32 as float64 does, ρ ≈ 0.02 in 8 iterations."""
    _assert_float32_fitness_of_the_tuned_champion(*_tuned_champion(3, 6))


@pytest.mark.slow
def test_float32_record_of_the_tuned_champion_is_the_old_block_underflow():
    """Levels 5-8 (255², the record's configuration; ~40 s on the CPU).

    The ρ 1e-16 in 1 iteration of the reference's float32 record is
    ZERO_RATE_CLAMP applied to a rate of exactly 0.  The power iteration
    then took one norm per block of 10 cycles, and ‖C¹⁰e‖ of a unit e
    (≈ 6e-18) squares to ≈ 1e-40 per entry at 255², which XLA on the CPU
    flushes to zero, so the block norm is 0.  It is not the NaN rule: the
    iterate stays finite.  Torch keeps the subnormals, so the port's norm
    of the same block is not 0, and under today's rule (a norm every
    cycle) both packages measure ρ ≈ 0.02 in 8 iterations."""
    jax.config.update("jax_enable_x64", True)
    je, te, reference, port = _tuned_champion(5, 8)
    _assert_float32_fitness_of_the_tuned_champion(je, te, reference, port)

    # The old rule: one norm per block of 10 cycles, from a unit error.
    vm, program = port._vm_program(te)
    step = vm.make_step()
    _, _, e0, zf = port._probe_state(te)
    e = tuple(x / sops.l2_norm(e0) for x in e0)
    jax_vm, jax_program = reference._vm_program(je)
    jax_step = jax.jit(jax_vm.make_step())
    jax_e = tuple(jnp.asarray(x.numpy()) for x in e)
    jax_zf = tuple(jnp.zeros_like(x) for x in jax_e)
    for _ in range(10):
        e = step(e, zf, program)
        jax_e = jax_step(jax_e, jax_zf, jax_program.as_arguments())
    assert all(bool(jnp.all(jnp.isfinite(x))) for x in jax_e)
    block_norm = float(jax_sops.l2_norm(jax_e))
    assert block_norm == 0.0
    assert 0.0 < float(sops.l2_norm(e)) < 1e-15
    # A block rate of exactly 0 is clamped, and scores one iteration.
    assert port._power_verdict(block_norm ** 0.1, INFINITY)[:2] == (ZERO_RATE_CLAMP, 1)
