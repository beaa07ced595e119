"""The ported fitness-evaluation slice against the JAX reference on the CPU.

Both packages get the same grammar trees (seeded `gp.gen_grow` on 2D
Poisson, levels 3-5, 31² finest) and the V(2,2) two-grid reference cycle,
each compiled through its own package's grammar and reference cycles: the
port keeps its own copy of the IR, so its IR objects are not the
reference's.

* float32 takes the power-iteration path on both sides.  They must agree
  on which individuals get an infinite time, on finite ρ within 1 %
  relative and on iterations within ±1: the summation order differs, and
  the power loop's 2 % rule can stop one block apart.
* float64 takes the restarted residual stages on both sides.  ρ must agree
  within 1e-8 relative with equal iteration counts.  These runs use the
  residual target 1e-6: at the default 1e-12 the last residuals of fast
  cycles sit within two decades of the float64 rounding floor (κ·ε ≈ 4e-14
  at 31²), where two correct implementations that sum in another order
  part by up to 5e-3 relative in ρ (V(2,2), measured), which would compare
  rounding instead of the stage logic.
* One cycle lowered from the IR, and one run through the VM with the
  reference's own program carried across, agree to float64 rounding.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.backend.vm import CycleVM as JaxVM
from evostencils_tpu.grammar import gp as jax_gp
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import reference_cycles as jax_reference_cycles
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch import NotPortedError, interop
from evostencils_torch.grammar import gp, multigrid
from evostencils_torch.ir import base, krylov, reference_cycles
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import CycleVM
from evostencils_torch.problems import load_problem_file
from evostencils_torch.problems.poisson import poisson_2d

INFINITY = 1e100


def _pset(problem, grammar):
    return grammar.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=2, maximum_local_system_size=8,
    )


class Side:
    """One package's problem, grammar and reference cycles, compiling
    shared tree strings."""

    def __init__(self, problem, gp_module, grammar, cycles):
        self.problem = problem
        self.gp = gp_module
        self.cycles = cycles
        self.pset, self.terminals = _pset(problem, grammar)

    def expressions(self, tree_strings):
        exprs = [self.gp.compile_tree(self.gp.parse_tree(s, self.pset), self.pset)[0]
                 for s in tree_strings]
        exprs.append(self.cycles.generate_v_22_cycle_two_grid(
            self.terminals[0], self.problem.rhs()))
        return exprs


def port_side(problem):
    return Side(problem, gp, multigrid, reference_cycles)


@pytest.fixture(scope="module")
def tree_strings():
    pset, _ = _pset(poisson_2d(3, 5, dtype=torch.float32), multigrid)
    rng = random.Random(5)
    return [str(gp.gen_grow(pset, 2, 16, rng=rng)) for _ in range(4)]


def _sides(np_dtype):
    return (
        Side(jax_poisson_2d(3, 5, dtype=jnp.dtype(np_dtype)),
             jax_gp, jax_multigrid, jax_reference_cycles),
        port_side(poisson_2d(3, 5, dtype=torch.float32 if np_dtype == np.float32 else torch.float64)),
    )


def test_float32_fitness_matches_reference(tree_strings):
    jax_side, torch_side = _sides(np.float32)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    port = TorchProgramGenerator(torch_side.problem, dtype=torch.float32, device="cpu")
    finite = 0
    for je, te in zip(jax_side.expressions(tree_strings), torch_side.expressions(tree_strings)):
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
        assert (t >= INFINITY) == (t_ref >= INFINITY), (t, t_ref)
        if rho_ref < INFINITY:
            assert abs(rho - rho_ref) <= 1e-2 * rho_ref, (rho, rho_ref)
            assert abs(it - it_ref) <= 1, (it, it_ref)
        finite += t_ref < INFINITY
    assert finite >= 2
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses)


def test_float64_staged_fitness_matches_reference(tree_strings):
    jax_side, torch_side = _sides(np.float64)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, epsilon=1e-6)
    port = TorchProgramGenerator(
        torch_side.problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    for je, te in zip(jax_side.expressions(tree_strings), torch_side.expressions(tree_strings)):
        _, rho_ref, it_ref = reference.generate_and_evaluate(je, evaluation_samples=1)
        _, rho, it = port.generate_and_evaluate(te, evaluation_samples=1)
        assert abs(rho - rho_ref) <= 1e-8 * rho_ref, (rho, rho_ref)
        assert it == it_ref
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses)


def test_one_cycle_matches_reference(tree_strings):
    jax_side, torch_side = _sides(np.float64)
    rng = np.random.default_rng(11)
    u0 = rng.standard_normal((31, 31))
    f = rng.standard_normal((31, 31))
    u0_t, f_t = interop.state_to_torch((u0, f), "cpu", torch.float64)

    # The V(2,2) cycle lowered from the IR.
    je, te = jax_side.expressions([])[0], torch_side.expressions([])[0]
    expected = JaxLowering(jnp.float64).lower(je)(
        (jnp.asarray(u0, dtype=jnp.float64),), (jnp.asarray(f, dtype=jnp.float64),))[0]
    got = CycleLowering(torch.float64, "cpu").lower(te)((u0_t,), (f_t,))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-12)

    # A random tree through both VMs, the reference's program carried across.
    je, te = jax_side.expressions(tree_strings[:1])[0], torch_side.expressions(tree_strings[:1])[0]
    jax_vm = JaxVM(JaxLowering(jnp.float64), jax_side.problem, 5)
    port_vm = CycleVM(CycleLowering(torch.float64, "cpu"), torch_side.problem, 5)
    jax_program = jax_vm.translate(je)
    program = interop.program_from_reference(jax_program)
    np.testing.assert_array_equal(program.opcodes, port_vm.translate(te).opcodes)
    expected = jax.jit(jax_vm.make_step())(
        (jnp.asarray(u0, dtype=jnp.float64),), (jnp.asarray(f, dtype=jnp.float64),),
        jax_program.as_arguments(),
    )[0]
    got = port_vm.make_step()((u0_t,), (f_t,), program)[0]
    scale = float(np.abs(np.asarray(expected)).max())
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(expected) / scale, atol=1e-12)


def test_unported_feature_raises_and_is_never_scored_infinity():
    assert not issubclass(NotPortedError, (RuntimeError, ValueError, NotImplementedError))
    side = port_side(poisson_2d(3, 5, dtype=torch.float64))
    cycle = side.expressions([])[0]
    # Problem files are not ported: they must raise, not score ∞.
    with pytest.raises(NotPortedError):
        load_problem_file("spec.exa2")
    # FAS evaluates now: a linear problem run as FAS (one stage, no power
    # iteration, no VM) still scores the cycle.
    fas_problem = side.problem._clone(uses_fas=True)
    port = TorchProgramGenerator(fas_problem, dtype=torch.float64, device="cpu")
    _, rho, _ = port.generate_and_evaluate(cycle, evaluation_samples=1)
    assert 0 < rho < 1 and (port.vm_hits, port.vm_misses) == (0, 1)
    with pytest.raises(NotPortedError):
        TorchProgramGenerator(side.problem, dtype=torch.float16, device="cpu")
    # A Krylov coarse-grid solver and a complex dtype are ported.
    t = side.terminals[0]
    u, f = t.approximation, side.problem.rhs()
    f_c = base.Multiplication(t.restriction, base.Residual(t.operator, u, f))
    solver = base.CoarseGridSolver(
        "CGS", t.coarse_operator, krylov.generate_conjugate_gradient(t.coarse_operator, 10))
    cycle = base.Cycle(
        u, f, base.Multiplication(t.prolongation, base.Multiplication(solver, f_c)),
        relaxation_factor=1.0,
    )
    port = TorchProgramGenerator(side.problem, dtype=torch.float64, device="cpu")
    _, rho, _ = port.generate_and_evaluate(cycle, evaluation_samples=1)
    assert 0 < rho < INFINITY
    assert TorchProgramGenerator(side.problem, dtype=torch.complex128, device="cpu")
