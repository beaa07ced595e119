"""The port's Helmholtz path against the JAX reference on the CPU.

Both packages build 2D Helmholtz (k = 20, levels 3-5, 31² finest, unless a
test says otherwise) through their own grammar and evaluate the textbook
V(2,1) ω = 0.6 and V(1,2) ω = 0.7 shifted-Laplace cycles as preconditioners
of BiCGStab on the outer operator.

What can be compared how tightly.  BiCGStab amplifies rounding: on this
problem the two packages' iterates agree to 4e-14 after 8 outer
iterations, to 2e-9 after 12 and to O(1) in the residual norm after 16
(measured in complex128; perturbing the right-hand side by one unit of
rounding inside the port alone does the same).  So

* where the arithmetic is short the comparison is tight: a solve capped at
  8 iterations (x and the residual norm within 1e-10), the probe's kill
  (ρ within 1e-9, equal counts), the inner cycle without the outer solve
  (ρ within 1e-12 in complex128, 1e-5 in complex64);
* where a solve runs to its target, the control flow must match exactly
  (the probe's verdict, the number of stages, VM hits, which runs converge)
  and the counts within a stated band: complex128 runs of 20-30 iterations
  land on the same count or one apart (measured 21 = 21, 20 = 20, 31 vs
  30, 27 vs 26; band ±2), and ρ = rel^(1/iterations), where rel is how far
  below the target the last step happens to land, within 10 % (measured
  5e-5 and 7 %).  complex64 runs of about 150 iterations, whose recurrence
  runs at the float32 floor, part by up to 15 % in the count (measured 148
  vs 171 and 131 vs 154, and 153 vs 172 inside the port alone under a
  one-unit perturbation of the right-hand side; band 25 %) and 3 % in ρ
  (band 5 %).
"""

import math
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import base as jax_base
from evostencils_tpu.ir import partitioning as jax_part
from evostencils_tpu.ir import reference_cycles as jax_cycles
from evostencils_tpu.ir import smoother as jax_smoother
from evostencils_tpu.problems import helmholtz as jax_helmholtz
from evostencils_torch import NotPortedError, interop
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import multigrid
from evostencils_torch.ir import base, partitioning, reference_cycles, smoother
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.optimization.relaxation import tune_outer_relaxation
from evostencils_torch.problems import build_named_problem, helmholtz
from scripts import torch_evaluate_helmholtz_ladder, torch_optimize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFINITY = 1e100
COUNT_BAND = 2  # iterations, complex128 runs of 20-30
RHO_BAND = 0.10
C64_COUNT_BAND = 0.25
C64_RHO_BAND = 0.05
TEXTBOOK = {"V21": (2, 1, 0.6), "V12": (1, 2, 0.7)}
JAX_DTYPES = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}


class Side:
    """One package's Helmholtz problem, terminals and IR modules."""

    def __init__(self, package, problem):
        self.problem = problem
        (self.grammar, self.cycles, self.base, self.smoother, self.part) = package
        self.terminals = self.grammar.generate_primitive_set(
            problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
            problem.max_level, problem.equations, problem.operators, problem.fields,
            depth=problem.max_level - problem.min_level, maximum_local_system_size=8)[1]

    def v_cycle(self, name):
        pre, post, omega = TEXTBOOK[name]
        return self.cycles.generate_v_cycle(
            self.terminals, self.problem.rhs(), pre_smoothing=pre, post_smoothing=post,
            omega=omega)

    def diverging_jacobi(self):
        """ω = 1.9 Jacobi without a coarse correction: diverges on M."""
        t0 = self.terminals[0]
        u, f, A = t0.approximation, self.problem.rhs(), t0.operator
        corr = self.base.Multiplication(
            self.base.Inverse(self.smoother.generate_collective_jacobi(A)),
            self.base.Residual(A, u, f))
        return self.base.Cycle(u, f, corr, partitioning=self.part.Single, relaxation_factor=1.9)


JAX = (jax_multigrid, jax_cycles, jax_base, jax_smoother, jax_part)
PORT = (multigrid, reference_cycles, base, smoother, partitioning)


def sides(dtype=torch.complex128, min_level=3, max_level=5, k=20.0, outer=True, **spec):
    """(reference side and generator, port side and generator) of the same
    Helmholtz problem, `spec` overriding entries of its outer-solver spec."""
    jax_problem = jax_helmholtz.helmholtz_2d(min_level, max_level, k=k, dtype=JAX_DTYPES[dtype])
    problem = helmholtz.helmholtz_2d(min_level, max_level, k=k, dtype=dtype)
    for p in (jax_problem, problem):
        p.outer_solver.update(spec)
    if not outer:
        jax_problem = jax_problem._clone(outer_solver=None)
        problem = problem._clone(outer_solver=None)
    return (
        Side(JAX, jax_problem), JaxProgramGenerator(jax_problem, dtype=JAX_DTYPES[dtype]),
        Side(PORT, problem), TorchProgramGenerator(problem, dtype=dtype, device="cpu"),
    )


def count_full_solves(generator):
    """Count the full-cap outer solves a generator of either package runs
    (stages and timing samples), by wrapping what `_build_outer_solver`
    hands out."""
    calls = []
    build = generator._build_outer_solver

    def counting_build(expression, probe_iterations=None):
        result = build(expression, probe_iterations=probe_iterations)
        if probe_iterations is not None:
            return result
        solve, operator = result[0]

        def counted(*args):
            calls.append(1)
            return solve(*args)

        return ((counted, operator),) + tuple(result[1:])

    generator._build_outer_solver = counting_build
    return calls


def cache_tags(generator):
    """The outer-solve tags ("outer", "outer_probe_N") among the solver
    cache's keys, which both packages key alike."""
    return sorted({part for key in generator._solver_cache for part in key
                   if isinstance(part, str) and part.startswith("outer")})


# ---- the problem family -------------------------------------------------


def test_problem_family_matches_reference():
    x, y = np.meshgrid(np.arange(1, 32) / 32, np.arange(1, 32) / 32, indexing="ij")
    np.testing.assert_array_equal(
        helmholtz.dirac_pulse_rhs(x, y), jax_helmholtz.dirac_pulse_rhs(x, y))
    assert helmholtz.helmholtz_ladder(4, k0=20.0) == jax_helmholtz.helmholtz_ladder(4, k0=20.0)
    assert [helmholtz.max_level_for_k(k) for k in (20.0, 80.0, 320.0)] == [5, 7, 9]
    problem, reference = helmholtz.helmholtz_2d(), jax_helmholtz.helmholtz_2d()
    assert problem.dtype == torch.complex64 and reference.dtype == jnp.complex64
    for key in ("type", "target_reduction", "max_iterations"):
        assert problem.outer_solver[key] == reference.outer_solver[key]
    assert (problem.name, problem.parameters, problem.residual_target, problem.iteration_limit) == (
        reference.name, reference.parameters, reference.residual_target,
        reference.iteration_limit)
    center = problem.finest_operator().entries[0][0].generate_stencil().center_value()
    assert complex(center) == complex(
        reference.finest_operator().entries[0][0].generate_stencil().center_value())
    assert abs(complex(center).imag) > 0

    named = build_named_problem("helmholtz", 5, 9)
    assert (named.min_level, named.max_level, named.parameters["k"]) == (3, 7, 80.0)
    robin = helmholtz.helmholtz_2d(boundary="robin")
    jax_robin = jax_helmholtz.helmholtz_2d(boundary="robin")
    grid, jax_grid = robin.finest_grid[0], jax_robin.finest_grid[0]
    for operator, jax_operator in (
            (robin.finest_operator().entries[0][0], jax_robin.finest_operator().entries[0][0]),
            (robin.outer_solver["operator_factory"](7, robin.parameters),
             jax_robin.outer_solver["operator_factory"](7, jax_robin.parameters))):
        gen = getattr(operator, "stencil_generator", operator)
        jax_gen = getattr(jax_operator, "stencil_generator", jax_operator)
        assert gen.is_variable()
        offsets, planes = gen.generate_coefficient_arrays(grid)
        jax_offsets, jax_planes = jax_gen.generate_coefficient_arrays(jax_grid)
        assert tuple(offsets) == tuple(jax_offsets)
        for plane, jax_plane in zip(planes, jax_planes):
            np.testing.assert_array_equal(plane, jax_plane)
    with pytest.raises(ValueError):
        helmholtz.helmholtz_2d(boundary="neumann")


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_initial_state_of_a_complex_problem_matches_reference(dtype):
    jax_side, _, side, _ = sides(dtype)
    for seeds in ({}, {"rhs_seed": 4}, {"init_seed": 5}):
        expected = jax_side.problem.initial_state(JAX_DTYPES[dtype], level=4, host=True, **seeds)
        got = side.problem.initial_state(dtype, level=4, **seeds)
        for e_state, g_state in zip(expected, got):
            for e, g in zip(e_state, g_state):
                assert g.dtype == e.dtype and np.iscomplexobj(g)
                np.testing.assert_array_equal(g, e)
    u0, f = side.problem.initial_state(dtype, device="cpu")
    assert u0[0].dtype == f[0].dtype == dtype
    carried = interop.state_to_torch(expected[1], "cpu", dtype)
    assert carried[0].dtype == dtype
    np.testing.assert_array_equal(carried[0].numpy(), expected[1][0])


# ---- the outer solve ------------------------------------------------------


@pytest.mark.parametrize("name", list(TEXTBOOK))
def test_outer_solve_matches_reference_while_the_arithmetic_is_short(name):
    """BiCGStab capped at 8 iterations, the cycle run through each VM."""
    jax_side, reference, side, port = sides()
    jax_cycle, cycle = jax_side.v_cycle(name), side.v_cycle(name)
    jax_vm, jax_program = reference._vm_program(jax_cycle)
    vm, program = port._vm_program(cycle)
    np.testing.assert_array_equal(
        program.opcodes, interop.program_from_reference(jax_program).opcodes)
    f = side.problem.initial_state(torch.complex128)[1]
    jax_solve = reference._outer_solve_raw(
        jax_vm.make_step(), reference._outer_operator_for(jax_cycle), 8)
    solve = port._outer_solve_raw(vm.make_step(), port._outer_operator_for(cycle), 8)
    x_ref, res_ref, res0_ref, it_ref = jax_solve(
        None, (jnp.asarray(f[0]),), jax_program.as_arguments())
    x, res, res0, it = solve(interop.state_to_torch(f, "cpu", torch.complex128), program)
    assert it == int(it_ref) == 8
    assert res0 == pytest.approx(float(res0_ref), rel=1e-14)
    assert abs(res - float(res_ref)) <= 1e-10 * float(res_ref)
    x_ref = np.asarray(x_ref[0])
    assert np.abs(x[0].numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


def test_helmholtz_fitness_matches_reference():
    jax_side, reference, side, port = sides()
    for name in TEXTBOOK:
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
            jax_side.v_cycle(name), evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(side.v_cycle(name), evaluation_samples=1)
        assert t < 1e50 and t_ref < 1e50
        assert it == it_ref, (name, it, it_ref)
        assert it < 500 and rho < 1.0
        assert abs(rho - rho_ref) <= RHO_BAND * rho_ref, (name, rho, rho_ref)
        # The probe (128 iterations) met the target alone: no stage ran.
        assert port.last_outer_solve == {
            "probe": "survived", "probe_iterations": it, "stages": 0}
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses) == (2, 0)
    assert cache_tags(port) == cache_tags(reference) == ["outer", "outer_probe_128"]
    # Two structures share the VM's solvers: nothing is keyed by structure.
    assert all(key[0] == "__vm__" for key in port._solver_cache)


def test_probe_kills_hopeless_preconditioner_without_full_solve():
    """The reference's case: a 2-iteration probe and a cap of 9.  The kill
    is short arithmetic, so the fitness matches to rounding."""
    jax_side, reference, side, port = sides(probe_iterations=2, max_iterations=9)
    ref_solves, solves = count_full_solves(reference), count_full_solves(port)
    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
        jax_side.diverging_jacobi(), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(side.diverging_jacobi(), evaluation_samples=1)
    assert t == t_ref == INFINITY
    assert it == it_ref and it >= 9
    assert 0 < rho and abs(rho - rho_ref) <= 1e-9 * rho_ref
    assert port.last_outer_solve == {"probe": "killed", "probe_iterations": 2, "stages": 0}
    assert not solves and not ref_solves
    assert cache_tags(port) == cache_tags(reference) == ["outer_probe_2"]


def test_probe_survivor_seeds_staged_solve():
    """An 8-iteration probe and a cap of 500: the survivor's total includes
    the probe's iterations, and one stage and one timing sample run."""
    jax_side, reference, side, port = sides(probe_iterations=8, max_iterations=500)
    ref_solves, solves = count_full_solves(reference), count_full_solves(port)
    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
        jax_side.v_cycle("V21"), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(side.v_cycle("V21"), evaluation_samples=1)
    assert t < 1e50 and t_ref < 1e50 and rho < 1.0
    assert it >= 8 and abs(it - it_ref) <= COUNT_BAND, (it, it_ref)
    assert abs(rho - rho_ref) <= RHO_BAND * rho_ref, (rho, rho_ref)
    assert port.last_outer_solve == {"probe": "survived", "probe_iterations": 8, "stages": 1}
    assert len(solves) == len(ref_solves) == 2
    assert cache_tags(port) == cache_tags(reference) == ["outer", "outer_probe_8"]


def test_block_smoother_misses_the_slim_vm_and_is_not_probed():
    """Outer-Krylov problems translate through the reference's slim ISA:
    a block smoother is lowered from the IR, counts as a VM miss and is
    never probed, on both sides."""
    jax_side, reference, side, port = sides(max_iterations=40)

    def block_cycle(s):
        t0 = s.terminals[0]
        u, f, A = t0.approximation, s.problem.rhs(), t0.operator
        corr = s.base.Multiplication(
            s.base.Inverse(s.smoother.generate_collective_block_jacobi(A, ((2, 2),))),
            s.base.Residual(A, u, f))
        return s.base.Cycle(u, f, corr, partitioning=s.part.Single, relaxation_factor=0.8)

    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
        block_cycle(jax_side), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(block_cycle(side), evaluation_samples=1)
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses) == (0, 1)
    assert port.last_outer_solve["probe"] == "skipped"
    assert (t >= INFINITY) == (t_ref >= INFINITY) and it == it_ref == 40
    assert abs(rho - rho_ref) <= RHO_BAND * rho_ref, (rho, rho_ref)
    assert cache_tags(port) == cache_tags(reference) == ["outer"]


def test_seeded_initial_guess_matches_reference():
    """`init_seed` skips the probe and solves the error equation of a
    seeded random guess.  Capped at 12 iterations the arithmetic is short:
    the same count and ρ within 1e-8."""
    jax_side, reference, side, port = sides(max_iterations=12)
    reference.init_seed = port.init_seed = 3
    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
        jax_side.v_cycle("V21"), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(side.v_cycle("V21"), evaluation_samples=1)
    assert t == t_ref == INFINITY and it == it_ref == 12
    assert abs(rho - rho_ref) <= 1e-8 * rho_ref, (rho, rho_ref)
    assert port.last_outer_solve == {"probe": "skipped", "probe_iterations": 0, "stages": 1}


def test_complex64_staged_path_matches_reference():
    """complex64 stages solve to 1e-6 and restart from the complex128 host
    residual: as many stages as the reference, counts and ρ in the bands."""
    jax_side, reference, side, port = sides(torch.complex64)
    ref_solves = count_full_solves(reference)
    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
        jax_side.v_cycle("V21"), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(side.v_cycle("V21"), evaluation_samples=1)
    assert t < 1e50 and t_ref < 1e50 and rho < 1.0
    # The reference's solves are its stages and one timing sample.
    assert port.last_outer_solve["stages"] == len(ref_solves) - 1 == 1
    assert port.last_outer_solve["probe"] == "survived"
    assert abs(it - it_ref) <= C64_COUNT_BAND * it_ref, (it, it_ref)
    assert abs(rho - rho_ref) <= C64_RHO_BAND * rho_ref, (rho, rho_ref)


@pytest.mark.parametrize("dtype,tolerance", [(torch.complex64, 1e-5), (torch.complex128, 1e-12)])
def test_inner_cycle_without_the_outer_solve_matches_reference(dtype, tolerance):
    """`--no-outer`: a complex problem with `outer_solver=None` measures ρ
    of the cycle on M, by power iteration in complex64 and by residual
    stages in complex128."""
    jax_side, reference, side, port = sides(dtype, outer=False)
    for name in TEXTBOOK:
        t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
            jax_side.v_cycle(name), evaluation_samples=1)
        t, rho, it = port.generate_and_evaluate(side.v_cycle(name), evaluation_samples=1)
        assert (t >= INFINITY) == (t_ref >= INFINITY)
        assert it == it_ref
        assert abs(rho - rho_ref) <= tolerance * rho_ref, (name, rho, rho_ref)
    assert port.last_outer_solve is None
    assert (port.vm_hits, port.vm_misses) == (reference.vm_hits, reference.vm_misses)


# ---- the k-ladder ---------------------------------------------------------


def _ladder_generator(**kwargs):
    return TorchProgramGenerator(
        helmholtz.helmholtz_2d(min_level=3, max_level=5), dtype=torch.complex64,
        device="cpu", **kwargs)


def test_ladder_success_averages(monkeypatch):
    gen = _ladder_generator()
    seen = []

    def fake(expression, infinity, evaluation_samples):
        seen.append(gen.problem.parameters["k"])
        return (30.0, 0.6, 30)

    monkeypatch.setattr(gen, "_generate_and_evaluate_measured", fake)
    t, rho, it = gen.generate_and_evaluate(object(), global_variable_values={"k": 80.0})
    assert seen == [80.0, 160.0, 320.0]
    assert (t, rho, it) == (30.0, 0.6, 30.0)
    assert gen.problem.parameters["k"] == 80.0


def test_ladder_failure_returns_sums(monkeypatch):
    gen = _ladder_generator()
    results = iter([(5.0, 0.4, 10), (1e100, 2.0, 500)])
    monkeypatch.setattr(gen, "_generate_and_evaluate_measured", lambda *a: next(results))
    t, rho, it = gen.generate_and_evaluate(object(), global_variable_values={"k": 80.0})
    assert t >= 1e100
    assert rho == pytest.approx(2.4)
    assert it == 510
    assert gen.problem.parameters["k"] == 80.0


def test_single_rung_evolution_mode(monkeypatch):
    gen = _ladder_generator(ladder_rungs=1)
    seen = []

    def fake(expression, infinity, evaluation_samples):
        seen.append(gen.problem.parameters["k"])
        return (30.0, 0.6, 30)

    monkeypatch.setattr(gen, "_generate_and_evaluate_measured", fake)
    t, rho, it = gen.generate_and_evaluate(object(), global_variable_values={"k": 80.0})
    assert seen == [80.0]
    assert (t, rho, it) == (30.0, 0.6, 30.0)
    assert gen.problem.parameters["k"] == 80.0


def test_ladder_restores_k_when_a_rung_raises(monkeypatch):
    gen = _ladder_generator()

    def fake(expression, infinity, evaluation_samples):
        if gen.problem.parameters["k"] == 160.0:
            raise NotPortedError("a rung that must not be scored")
        return (30.0, 0.6, 30)

    monkeypatch.setattr(gen, "_generate_and_evaluate_measured", fake)
    with pytest.raises(NotPortedError):
        gen.generate_and_evaluate(object(), global_variable_values={"k": 80.0})
    assert gen.problem.parameters["k"] == 80.0


def test_parameter_signature_keys_caches():
    gen = _ladder_generator()
    sig80 = gen._param_sig
    gen._apply_parameter_values({"k": 160.0})
    assert gen._param_sig != sig80
    assert gen._vm_for(5) is gen._vm_for(5)
    vm160 = gen._vm_for(5)
    gen._apply_parameter_values({"k": 80.0})
    assert gen._vm_for(5) is not vm160 and gen._param_sig == sig80


def test_k_ladder_matches_reference():
    """A real ladder on both sides: k = 5, 10, 20 on levels 3-4, complex128.
    The first rung (6 iterations) is equal; on the 15² grid the higher
    rungs are far under-resolved (h·k up to 1.25) and take 20-50
    iterations, so the means agree within 15 % (measured 25.67 vs 23.0)."""
    jax_side, reference, side, port = sides(min_level=3, max_level=4, k=5.0)
    rungs = {}
    for label, generator in (("reference", reference), ("port", port)):
        measured = generator._generate_and_evaluate_measured
        rungs[label] = []

        def recording(expression, infinity, evaluation_samples, _measured=measured,
                      _generator=generator, _rungs=rungs[label]):
            result = _measured(expression, infinity, evaluation_samples)
            _rungs.append((_generator.problem.parameters["k"],) + tuple(result))
            return result

        generator._generate_and_evaluate_measured = recording
    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(
        jax_side.v_cycle("V21"), evaluation_samples=1, global_variable_values={"k": 5.0})
    t, rho, it = port.generate_and_evaluate(
        side.v_cycle("V21"), evaluation_samples=1, global_variable_values={"k": 5.0})
    assert [r[0] for r in rungs["port"]] == [r[0] for r in rungs["reference"]] == [5.0, 10.0, 20.0]
    assert rungs["port"][0][3] == rungs["reference"][0][3] == 6
    assert abs(rungs["port"][0][2] - rungs["reference"][0][2]) <= 1e-6 * rungs["reference"][0][2]
    # The reference's rule on each side: the mean over the rungs.
    for label, result in (("reference", (t_ref, rho_ref, it_ref)), ("port", (t, rho, it))):
        assert result[2] == pytest.approx(sum(r[3] for r in rungs[label]) / 3)
        assert result[1] == pytest.approx(sum(r[2] for r in rungs[label]) / 3)
    assert abs(it - it_ref) <= 0.15 * it_ref, (it, it_ref)
    assert port.problem.parameters["k"] == reference.problem.parameters["k"] == 5.0


def test_k_ladder_generalization(tmp_path):
    """The generalization ramp with a PDE-parameter ladder: k doubles as
    the grid refines (tests/test_problems.py's run, on the port, with the
    outer cap cut from 10,000 to 40 iterations: eager torch on the CPU takes
    milliseconds per outer iteration, and what is checked here is the ramp)."""
    problem = helmholtz.helmholtz_2d(min_level=3, max_level=4, k=5.0, dtype=torch.complex128)
    problem.outer_solver["max_iterations"] = 40
    gen = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
    opt = Optimizer.for_problem(
        problem, program_generator=gen, checkpoint_directory_path=str(tmp_path),
        rng=random.Random(6))
    best, prog, pops, logs, hofs = opt.evolutionary_optimization(
        mu_=3, lambda_=3, population_initialization_factor=1, generations=2,
        generalization_interval=1, optimization_method=opt.SOGP,
        evaluation_samples=1, maximum_local_system_size=4,
        pde_parameter_values={"k": [5.0, 10.0]}, verbose=False,
    )
    assert opt.program_generator.problem.parameters["k"] == 10.0
    assert opt.program_generator.problem.max_level == 5
    assert hofs[-1][0].fitness_values is not None


# ---- the stored champion, the evolution and the tuner ---------------------


def test_k320_champion_regression(capsys):
    """The stored k = 320 champion (levels 3-7, 127², complex128) still
    converges under the reference's own limit of 8,000 outer iterations
    (tests/test_problems.py); the reference measured 6,515.  Over
    thousands of non-monotone iterations the count is a property of the
    rounding as much as of the cycle, so it is printed, not compared."""
    with open(os.path.join(ROOT, "artifacts", "helmholtz_k320_r5", "individual_0.txt")) as f:
        champion = "".join(line for line in f if not line.startswith("#")).strip()
    problem = helmholtz.helmholtz_2d(min_level=3, max_level=7, k=320.0, dtype=torch.complex128)
    gen = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
    opt = Optimizer.for_problem(problem, program_generator=gen, rng=random.Random(0))
    t, rho, iterations = opt.generate_and_evaluate_program_from_grammar_representation(
        champion, 4, evaluation_samples=1)
    with capsys.disabled():
        print(f"\nk=320 champion on the port (CPU): {iterations} outer iterations, "
              f"ρ {rho:.6f}; the reference measured 6515")
    assert t < 1e50 and rho < 1.0
    assert iterations <= 8000
    assert gen.last_outer_solve == {"probe": "survived", "probe_iterations": 128, "stages": 1}


@pytest.mark.slow
def test_k320_champion_count_follows_the_summation_order(monkeypatch, capsys):
    """The same champion solve with BiCGStab's inner products summed in
    another order (rows first, or the flipped array): nothing but the
    rounding of the reductions changes, and the count moves by about 10 %
    either way (measured 6,804 and 7,828 against 7,545).  Slow: two solves
    of about 7,000 outer iterations, 40 to 50 s each."""
    from evostencils_torch.ops import krylov

    def rows_first(x, y):
        return torch.sum(torch.sum(torch.conj(x) * y, dim=1))

    def flipped(x, y):
        return torch.sum((torch.conj(x) * y).flip(0, 1).contiguous())

    with open(os.path.join(ROOT, "artifacts", "helmholtz_k320_r5", "individual_0.txt")) as f:
        champion = "".join(line for line in f if not line.startswith("#")).strip()
    counts = {}
    for name, field_dot in (("rows first", rows_first), ("flipped", flipped)):
        monkeypatch.setattr(
            krylov, "dot", lambda a, b, _dot=field_dot: sum(_dot(x, y) for x, y in zip(a, b)))
        problem = helmholtz.helmholtz_2d(min_level=3, max_level=7, k=320.0, dtype=torch.complex128)
        gen = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
        opt = Optimizer.for_problem(problem, program_generator=gen, rng=random.Random(0))
        t, rho, counts[name] = opt.generate_and_evaluate_program_from_grammar_representation(
            champion, 4, evaluation_samples=1)
        assert t < 1e50 and rho < 1.0
    with capsys.disabled():
        print(f"\nk=320 champion on the port (CPU), outer iterations by summation order: {counts}; "
              "7545 in torch's own order, 6515 in the reference")
    assert len(set(counts.values()) | {7545}) > 1


EVOLVE = ["--cpu", "--problem", "helmholtz", "--helmholtz-k0", "20", "--min-level", "3",
          "--max-level", "5", "--dtype", "complex128", "--method", "sogp", "--mu", "4",
          "--lambda", "4", "--generations", "1", "--ladder-rungs", "1", "--outer-cap", "60",
          "--evaluation-samples", "1", "--seed", "3"]


def test_helmholtz_evolution_entry_point(tmp_path):
    run = torch_optimize.run(EVOLVE + ["--output", str(tmp_path)])
    assert run.generator.dtype == torch.complex128 and run.generator.ladder_rungs == 1
    assert run.generator.problem.outer_solver["max_iterations"] == 60
    assert run.generator.problem.parameters["k"] == 20.0
    best = run.halls_of_fame[-1][0]
    assert all(math.isfinite(v) for v in best.fitness_values)
    assert best.fitness_values[0] < run.optimizer.infinity
    assert os.path.isfile(tmp_path / "individual_0.txt")
    # Re-evaluated as the EA evaluated it, the best gives its count again.
    expr = run.optimizer.compile_individual(best)[0]
    first = run.generator.generate_and_evaluate(
        expr, evaluation_samples=1, global_variable_values={"k": 20.0})
    again = run.generator.generate_and_evaluate(
        expr, evaluation_samples=1, global_variable_values={"k": 20.0})
    assert first[1:] == again[1:] and first[0] < 1e50


def test_evolution_flags_build_the_reference_s_problem():
    build = lambda *flags: torch_optimize._build_problem(  # noqa: E731
        torch_optimize.parse_arguments(["--cpu", *flags]))
    default = build("--problem", "helmholtz")
    assert (default.min_level, default.max_level, default.dtype) == (3, 7, torch.complex64)
    assert default.outer_solver["max_iterations"] == 10000
    k0 = build("--problem", "helmholtz", "--helmholtz-k0", "20", "--outer-cap", "600")
    assert (k0.max_level, k0.parameters["k"]) == (5, 20.0)
    assert k0.outer_solver["max_iterations"] == 600
    inner = build("--problem", "helmholtz", "--no-outer", "--dtype", "complex128")
    assert inner.outer_solver is None and inner.dtype == torch.complex128
    poisson = build()
    assert (poisson.min_level, poisson.max_level, poisson.dtype) == (5, 9, torch.float32)


def test_outer_relaxation_tuner_does_not_raise_the_count():
    _, _, side, port = sides()
    cycle = side.v_cycle("V21")
    _, _, before = port.generate_and_evaluate(cycle, evaluation_samples=1)
    tuned, best = tune_outer_relaxation(cycle, port, iterations=2, seed=0)
    _, _, after = port.generate_and_evaluate(cycle, evaluation_samples=1)
    assert len(tuned) == len(port._omega_vector(cycle))
    assert after <= before and int(best) == after


def test_ladder_script_on_the_cpu(tmp_path, capsys):
    generator, rows = torch_evaluate_helmholtz_ladder.run(
        ["--cpu", "--dtype", "complex128", "--min-level", "3", "--max-level", "5", "--k", "20",
         "--rungs", "2", "--max-iterations", "400", "--no-default-textbooks",
         "--textbook", "2,1,0.6", "--tune-outer", "1", "--save-tuned", str(tmp_path)])
    assert generator.device.type == "cpu" and generator.dtype == torch.complex128
    (name, per_k), = rows
    assert [r.k for r in per_k] == [20.0, 40.0]
    assert per_k[0].converged and per_k[0].iterations <= 21
    assert generator.problem.parameters["k"] == 20.0
    assert "| textbook V(2,1) ω=0.6 | 20 | converged to 1e-7 |" in capsys.readouterr().out
    (saved,) = os.listdir(tmp_path)
    assert saved.endswith("_tuned.txt")
    assert "# tuned omegas:" in open(tmp_path / saved).read()


def test_ladder_script_needs_the_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        torch_evaluate_helmholtz_ladder.main(["--rungs", "1"])
    assert exit_info.value.code != 0
    assert "--cpu" in capsys.readouterr().err
    assert torch_evaluate_helmholtz_ladder.parse_arguments(["--cpu"]).dtype == "complex64"
