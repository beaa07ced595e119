"""The port's models (models/lfa.py, models/roofline.py), the model-based
fitness, the LFA default of the intergrid optimiser, tree drawing and the
evaluation report against the JAX package's, on the CPU.

Each side builds its expressions through its own package's grammar and IR.
Tolerances:
  * LFA ρ equal to the reference to 1e-12 (the same numpy on both sides):
    damped Jacobi, the Trottenberg two-grid table, ω-Jacobi two-grid,
    seeded grammar trees and the complex shifted-Laplace two-grid cycles of
    tests/test_models.py;
  * the roofline's runtime and traffic equal to 1e-12 relative when the
    port's model takes the reference's TPU constants (interop);
  * a model-based NSGA-II run of 2 generations breeds the same populations,
    fitness tuples and halls of fame from the same `random.Random` seed;
  * `optimize_intergrid_weights` with the LFA default: the same weights and
    ρ (equal floats);
  * `to_dot` equal strings;
  * the committed H100 constants equal roofline_calibration_h100.json,
    whose cases lie within the reference's gate of 1/1.35 to 1.35, but for
    the one case named in OUTSIDE_GATE, held within 2×.
"""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.ir import reference_cycles as jax_reference_cycles
from evostencils_tpu.models.lfa import ConvergenceEvaluator as JaxLFA
from evostencils_tpu.models.roofline import PerformanceEvaluator as JaxRoofline
from evostencils_tpu.optimization import intergrid_transfer as jax_intergrid
from evostencils_tpu.optimization.optimizer import Optimizer as JaxOptimizer
from evostencils_tpu.problems.helmholtz import helmholtz_2d as jax_helmholtz_2d
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.utils import visualization as jax_visualization
from evostencils_torch import interop
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ir import reference_cycles
from evostencils_torch.models import roofline
from evostencils_torch.models.lfa import ConvergenceEvaluator
from evostencils_torch.optimization import intergrid_transfer
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils import profiling, visualization
from tests.torch_parity import JAX, PORT, Side, seeded_trees

# The one case the reference's staged fit leaves outside the 1.35 gate on the
# H100 (PERF.md, PR 6): a plain-Jacobi sweep is ~13 eager torch launches,
# a red-black sweep one kernel, and the walker charges one launch cost per
# costed pass, so the launch-bound 511² Jacobi V-cycle is under-predicted
# (0.70) while its bandwidth-bound 1023² twin sits at 1.19.  Held to the
# reference's earlier gate of 2× instead.
OUTSIDE_GATE = {"V(2,2)_jacobi_512"}
CALIBRATION = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "evostencils_torch", "models", "roofline_calibration_h100.json")


def _two_level(package):
    problem = (jax_poisson_2d(min_level=5, max_level=6, dtype=jnp.float64) if package is JAX
               else poisson_2d(min_level=5, max_level=6, dtype=torch.float64))
    return Side(package, problem, depth=1, maximum_local_system_size=4)


def _smooth(side, u, f, nu, red_black=True, w=1.0):
    b, sm, part = side.package.base, side.package.smoother, side.package.part
    A = side.terminals[0].operator
    for _ in range(nu):
        corr = b.Multiplication(b.Inverse(sm.generate_collective_jacobi(A)), b.Residual(A, u, f))
        u = b.Cycle(u, f, corr, partitioning=part.RedBlack if red_black else part.Single,
                    relaxation_factor=w)
    return u


def _two_grid(side, nu1, nu2, red_black=True, w=1.0):
    b, t0 = side.package.base, side.terminals[0]
    f = side.problem.rhs()
    u1 = _smooth(side, t0.approximation, f, nu1, red_black, w)
    f_c = b.Multiplication(t0.restriction, b.Residual(t0.operator, u1, f))
    cgc = b.Multiplication(b.CoarseGridSolver("CGS", t0.coarse_operator), f_c)
    u2 = b.Cycle(u1, f, b.Multiplication(t0.prolongation, cgc), relaxation_factor=1.0)
    return _smooth(side, u2, f, nu2, red_black, w)


def _lfa(side, samples=16):
    evaluator = (JaxLFA if side.package is JAX else ConvergenceEvaluator)
    return evaluator(2, side.problem.coarsening_factors, side.problem.finest_grid,
                     samples_per_axis=samples)


POISSON_CASES = {
    "jacobi_0.5": lambda s: _smooth(s, s.terminals[0].approximation, s.problem.rhs(), 1, False, 0.5),
    "jacobi_0.8": lambda s: _smooth(s, s.terminals[0].approximation, s.problem.rhs(), 1, False, 0.8),
    # Trottenberg et al., Multigrid, Table 4.1: RB-GS + FW + bilinear.
    "rb_1_0": lambda s: _two_grid(s, 1, 0),
    "rb_1_1": lambda s: _two_grid(s, 1, 1),
    "rb_2_1": lambda s: _two_grid(s, 2, 1),
    "rb_2_2": lambda s: _two_grid(s, 2, 2),
    "omega_jacobi_1_1": lambda s: _two_grid(s, 1, 1, red_black=False, w=0.8),
}


@pytest.mark.parametrize("case", sorted(POISSON_CASES))
def test_lfa_equals_reference_on_textbook_cycles(case):
    rhos = [_lfa(side).compute_spectral_radius(POISSON_CASES[case](side))
            for side in (_two_level(JAX), _two_level(PORT))]
    assert 0.0 < rhos[0] < 1.0
    assert abs(rhos[1] - rhos[0]) <= 1e-12, rhos


def test_lfa_equals_reference_on_seeded_trees():
    jax_side, port_side = _two_level(JAX), _two_level(PORT)
    jax_lfa, port_lfa = _lfa(jax_side, 8), _lfa(port_side, 8)
    rhos = []
    for tree in seeded_trees(port_side, 11, 12):
        expected = jax_lfa.compute_spectral_radius(jax_side.compile(tree))
        got = port_lfa.compute_spectral_radius(port_side.compile(tree))
        assert abs(got - expected) <= 1e-12 * max(1.0, abs(expected)), (tree, got, expected)
        rhos.append(got)
    assert any(0.0 < r < 1.0 for r in rhos)


@pytest.mark.parametrize("k, levels, pre, post, omega", [
    (20.0, (4, 5), 1, 1, 0.8), (20.0, (4, 5), 2, 1, 0.6), (40.0, (5, 6), 2, 1, 0.6)])
def test_lfa_equals_reference_on_complex_shifted_laplace(k, levels, pre, post, omega):
    rhos = []
    for package in (JAX, PORT):
        make = jax_helmholtz_2d if package is JAX else helmholtz_2d
        dtype = jnp.complex128 if package is JAX else torch.complex128
        problem = make(min_level=levels[0], max_level=levels[1], k=k, dtype=dtype)
        problem = problem._clone(outer_solver=None)
        side = Side(package, problem)
        cycles = jax_reference_cycles if package is JAX else reference_cycles
        cycle = cycles.generate_v_cycle(side.terminals, problem.rhs(), pre, post, omega=omega)
        evaluator = JaxLFA if package is JAX else ConvergenceEvaluator
        rhos.append(evaluator(2, problem.coarsening_factors, problem.finest_grid)
                    .compute_spectral_radius(cycle))
    assert rhos[0] > 0.0
    assert abs(rhos[1] - rhos[0]) <= 1e-12, rhos


def _bench_side(package):
    problem = (jax_poisson_2d(min_level=5, max_level=9, dtype=jnp.float32) if package is JAX
               else poisson_2d(min_level=5, max_level=9, dtype=torch.float32))
    return Side(package, problem, depth=4)


def test_roofline_equals_reference_with_the_reference_constants():
    jax_side, port_side = _bench_side(JAX), _bench_side(PORT)
    reference = JaxRoofline()
    port = interop.performance_evaluator_from_reference(reference)
    expressions = [
        (jax_reference_cycles.generate_v_cycle(jax_side.terminals, jax_side.problem.rhs(), pre, post),
         reference_cycles.generate_v_cycle(port_side.terminals, port_side.problem.rhs(), pre, post))
        for pre, post in ((2, 1), (2, 2), (1, 0))
    ]
    expressions += [(jax_side.compile(t), port_side.compile(t))
                    for t in seeded_trees(port_side, 20260816, 8)]
    for jax_expr, port_expr in expressions:
        expected = reference.estimate_runtime_and_traffic(jax_expr)
        got = port.estimate_runtime_and_traffic(port_expr)
        assert expected[0] > 0.0 and expected[1] > 0.0
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0)


def _model_based_run(package, tmp_path):
    if package is JAX:
        problem = jax_poisson_2d(min_level=5, max_level=6, dtype=jnp.float64)
        generator = JaxProgramGenerator(problem, dtype=jnp.float64)
        convergence = JaxLFA(2, problem.coarsening_factors, problem.finest_grid,
                             samples_per_axis=4)
        performance, optimizer_class = JaxRoofline(), JaxOptimizer
    else:
        problem = poisson_2d(min_level=5, max_level=6, dtype=torch.float64)
        generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
        convergence = ConvergenceEvaluator(2, problem.coarsening_factors, problem.finest_grid,
                                           samples_per_axis=4)
        performance, optimizer_class = (
            interop.performance_evaluator_from_reference(JaxRoofline()), Optimizer)
    optimizer = optimizer_class.for_problem(
        problem, program_generator=generator, convergence_evaluator=convergence,
        performance_evaluator=performance,
        checkpoint_directory_path=str(tmp_path / ("jax" if package is JAX else "torch")),
        rng=random.Random(5))
    best, program, pops, logbooks, hofs = optimizer.evolutionary_optimization(
        mu_=4, lambda_=4, population_initialization_factor=2, generations=2,
        generalization_interval=100, optimization_method=optimizer.NSGAII,
        model_based_estimation=True, evaluation_samples=1, maximum_local_system_size=4,
        verbose=False)
    return {
        "best": str(best),
        "populations": [[(str(i), i.fitness_values) for i in pop] for pop in pops],
        "halls_of_fame": [[(str(i), i.fitness_values) for i in hof] for hof in hofs],
        "evaluations": optimizer._total_number_of_evaluations,
    }


def test_model_based_nsga2_breeds_the_reference_populations(tmp_path):
    expected = _model_based_run(JAX, tmp_path)
    got = _model_based_run(PORT, tmp_path)
    assert got == expected
    rho, runtime = got["halls_of_fame"][-1][0][1]
    assert 0 < rho < 1 and runtime > 0
    assert got["evaluations"] > 0


def test_intergrid_weights_with_the_lfa_default_match_reference():
    kwargs = dict(generations=3, seed=1, samples_per_axis=4)
    r, p, rho, history = intergrid_transfer.optimize_intergrid_weights(
        poisson_2d(4, 5, dtype=torch.float64), **kwargs)
    jr, jp, jrho, jhistory = jax_intergrid.optimize_intergrid_weights(
        jax_poisson_2d(4, 5), **kwargs)
    assert rho == jrho and history == jhistory
    assert sorted(r.entries) == sorted(jr.entries)
    assert sorted(p.entries) == sorted(jp.entries)
    assert 0.0 < rho <= history[0] < 1.0


def test_to_dot_and_draw_tree_equal_reference(tmp_path):
    port_side, jax_side = _bench_side(PORT), _bench_side(JAX)
    rng = random.Random(3)
    for _ in range(4):
        tree = port_side.package.gp.gen_grow(port_side.pset, 2, 10, rng=rng)
        jax_tree = jax_side.package.gp.parse_tree(str(tree), jax_side.pset)
        assert visualization.to_dot(tree) == jax_visualization.to_dot(jax_tree)
    Optimizer.visualize_tree(tree, str(tmp_path / "tree"))
    with open(tmp_path / "tree.dot") as fh:
        assert fh.read() == jax_visualization.to_dot(jax_tree)


def test_evaluation_report_and_bandwidth(tmp_path):
    problem = poisson_2d(3, 5, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    side = Side(PORT, problem)
    generator.generate_and_evaluate(
        reference_cycles.generate_v_cycle(side.terminals, problem.rhs(), 2, 1),
        evaluation_samples=1)
    report = profiling.evaluation_report(generator)
    assert set(report) == {"run_time_s", "solver_cache_entries", "device_failures", "groups",
                           "group_members", "vm_hits", "vm_misses", "vm_pad_overflows",
                           "vm_isa_recompiles", "vm_hit_rate"}
    assert report["vm_hits"] + report["vm_misses"] == 1 and report["solver_cache_entries"] == 1
    expression = reference_cycles.generate_v_cycle(side.terminals, problem.rhs(), 2, 1)
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as traced:
        generator.generate_and_evaluate(expression, evaluation_samples=1)
    assert os.path.getsize(traced.path) > 0


def test_h100_constants_equal_the_calibration_file():
    if not os.path.isfile(CALIBRATION):
        pytest.skip("no H100 calibration file (scripts/torch_calibrate_roofline.py on the card)")
    with open(CALIBRATION) as fh:
        data = json.load(fh)
    assert roofline.RED_BLACK_PENALTY_H100 == pytest.approx(data["red_black_penalty"], rel=1e-6)
    assert roofline.KERNEL_LAUNCH_OVERHEAD_H100 == pytest.approx(
        data["kernel_launch_overhead_s"], rel=1e-6, abs=1e-12)
    assert roofline.FUSION_FACTOR_H100 == pytest.approx(data["fusion_factor"], rel=1e-6)
    assert roofline.SINGLE_SWEEP_FUSION_H100 == pytest.approx(
        data["single_sweep_fusion"], rel=1e-6)
    assert roofline.INTERGRID_FACTOR_H100 == pytest.approx(data["intergrid_factor"], rel=1e-6)
    assert "H100" in data["device"]
    outside = set()
    for case in data["cases"]:
        ratio = case["predicted_s"] / case["measured_s"]
        if not 1 / 1.35 <= ratio <= 1.35:
            outside.add(case["case"])
            assert 0.5 <= ratio <= 2.0, f"{case['case']}: predicted/measured = {ratio:.2f}"
    assert outside <= OUTSIDE_GATE, outside
