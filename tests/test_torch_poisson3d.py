"""The port's 3D Poisson path against the JAX reference on the CPU.

3D 7-point Poisson, levels 2-4 (15³ finest).  One V(2,2) cycle lowered on
both sides agrees to 1e-12 relative to max|u|; seeded grammar trees and a
V(2,1) with a 2×4×1 block smoother score within the bands of
tests/test_torch_slice.py (float32 ρ 1 %, iterations ±1, the same
infinities; float64 staged at ε = 1e-6, ρ 1e-8 and equal iterations); the
cycle VM numbers a 3D tree's instructions as the reference's VM does; and
the red-black sweep kernel, which is 2D, is never asked to run on a 3D
field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.backend.vm import CycleVM as JaxVM
from evostencils_tpu.problems import poisson as jax_poisson
from evostencils_torch import interop
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import CycleVM
from evostencils_torch.ops import rb_sweep
from evostencils_torch.problems import build_named_problem, poisson
from torch_parity import (
    INFINITY, JAX, JAX_DTYPES, PORT, Side, assert_close_relative, jax_state, seeded_trees,
)

BLOCK = (2, 4, 1)


def _sides(dtype):
    return (Side(JAX, jax_poisson.poisson_3d(2, 4, dtype=JAX_DTYPES[dtype])),
            Side(PORT, poisson.poisson_3d(2, 4, dtype=dtype)))


def _trees():
    return seeded_trees(_sides(torch.float32)[1], seed=9, count=4)


def test_problem_matches_reference():
    jax_problem, problem = jax_poisson.poisson_3d(), poisson.poisson_3d()
    assert (problem.name, problem.dimension, problem.min_level, problem.max_level) == (
        jax_problem.name, jax_problem.dimension, jax_problem.min_level, jax_problem.max_level)
    for lo, hi in ((5, 9), (3, 6), (2, 10)):
        named = build_named_problem("poisson3d", lo, hi)
        assert (named.min_level, named.max_level) == (max(2, lo - 2), min(hi, 7))
    expected = jax_poisson.poisson_3d(2, 4).rhs_arrays(jnp.float64, host=True)
    for e, g in zip(expected, poisson.poisson_3d(2, 4).rhs_arrays(torch.float64)):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("kind", ["collective", BLOCK])
def test_one_cycle_matches_reference(kind):
    jax_side, side = _sides(torch.float64)
    rng = np.random.default_rng(12)
    u0, f = (rng.standard_normal((15, 15, 15)),), (rng.standard_normal((15, 15, 15)),)
    expected = JaxLowering(jnp.float64, use_pallas=False).lower(jax_side.cycle(2, 2, 1.0, kind))(
        jax_state(u0, jnp.float64), jax_state(f, jnp.float64))
    got = CycleLowering(torch.float64, "cpu").lower(side.cycle(2, 2, 1.0, kind))(
        interop.state_to_torch(u0, "cpu", torch.float64),
        interop.state_to_torch(f, "cpu", torch.float64))
    assert_close_relative(got, expected, 1e-12)


def test_float32_fitness_matches_reference():
    jax_side, side = _sides(torch.float32)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    port = TorchProgramGenerator(side.problem, dtype=torch.float32, device="cpu")
    pairs = [(jax_side.compile(s), side.compile(s)) for s in _trees()]
    pairs.append((jax_side.cycle(2, 1, 1.0, BLOCK), side.cycle(2, 1, 1.0, BLOCK)))
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
    pairs = [(jax_side.compile(s), side.compile(s)) for s in _trees()]
    pairs.append((jax_side.cycle(2, 1, 1.0, BLOCK), side.cycle(2, 1, 1.0, BLOCK)))
    for je, te in pairs:
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
        assert (t >= INFINITY) == (t_ref >= INFINITY), (t, t_ref)
        if t_ref >= INFINITY:
            # A stagnating cycle (the second tree: ρ 0.992, the residual
            # flat to 1e-14 relative for its last iterations) stops at its
            # stall patience, and which of the equal residuals counts as the
            # best one is rounding: 65 on one side, 69 on the other.
            assert abs(rho - rho_ref) <= 1e-3 * rho_ref, (rho, rho_ref)
            continue
        assert abs(rho - rho_ref) <= 1e-8 * rho_ref, (rho, rho_ref)
        assert it == it_ref


def test_vm_opcodes_match_reference():
    jax_side, side = _sides(torch.float64)
    jax_vm = JaxVM(JaxLowering(jnp.float64, use_pallas=False), jax_side.problem, 4)
    port_vm = CycleVM(CycleLowering(torch.float64, "cpu"), side.problem, 4)
    assert len(port_vm._branches) == len(jax_vm._branches)
    cycles = [(jax_side.compile(s), side.compile(s)) for s in _trees()]
    cycles.append((jax_side.cycle(2, 1, 1.0, BLOCK), side.cycle(2, 1, 1.0, BLOCK)))
    translated = 0
    for je, te in cycles:
        jax_program, program = jax_vm.translate(je), port_vm.translate(te)
        assert (jax_program is None) == (program is None)
        if program is not None:
            np.testing.assert_array_equal(
                interop.program_from_reference(jax_program).opcodes, program.opcodes)
            translated += 1
    assert translated >= 2


def test_no_kernel_launch_on_a_3d_field(monkeypatch):
    """The gate refuses 3D: a red-black collective-Jacobi cycle lowered with
    the kernels on never reaches the fused sweep."""
    calls = []

    def probe(u, f, omega, stencil):
        calls.append(tuple(u.shape))
        return rb_sweep.rb_sweep_reference(u, f, omega, stencil)

    monkeypatch.setattr(rb_sweep, "red_black_collective_jacobi_sweep", probe)
    _, side = _sides(torch.float32)
    lowering = CycleLowering(torch.float32, "cpu", use_kernels=True)
    u0, f = side.problem.initial_state(torch.float32, device="cpu")
    out = lowering.lower(side.cycle(2, 2, 1.0))(u0, f)
    assert not calls and out[0].shape == (15, 15, 15) and torch.isfinite(out[0]).all()
    # The same on 2D, as a check that the probe sees the sweep at all.
    two_d = Side(PORT, poisson.poisson_2d(3, 5, dtype=torch.float32))
    u0, f = two_d.problem.initial_state(torch.float32, device="cpu")
    lowering.lower(two_d.cycle(1, 1, 1.0))(u0, f)
    assert calls
