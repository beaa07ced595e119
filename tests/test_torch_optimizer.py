"""The port's evolutionary optimizer against the JAX package's.

* EA logic parity: both packages' `Optimizer` get the same deterministic
  stub generator, a pure function of `canonical_string(expr)` (each side
  through its own IR), and the same `random.Random(seed)`.  SOGP, NSGA-II
  and NSGA-III must then evolve identical populations: the best string, the
  program, every population's strings and fitness tuples, the halls of fame
  and the logbook records (less `gen_s`, the wall seconds of a generation).
  The cases include multi-run level splitting (`levels_per_run=2`, which
  chains NestedCycleSolver) and the generalization ramp.
* The port's own multi-run and checkpoint-resume cases, with the real
  TorchProgramGenerator on the CPU (float64, levels 3-7, at most 100
  iterations).
* The entry points default to the card.
"""

import hashlib
import math
import os
import random

import jax.numpy as jnp
import pytest
import torch

from evostencils_tpu.ir.transformations import canonical_string as jax_canonical_string
from evostencils_tpu.optimization.optimizer import Optimizer as JaxOptimizer
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar.multigrid import generate_primitive_set, textbook_cycle_string
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.problems import build_named_problem, load_problem_file
from evostencils_torch.problems.poisson import poisson_2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INFINITY = 1e100


class StubGenerator:
    """A program generator whose fitness is a pure function of the
    expression's canonical string: (t, ρ, iterations) from its digest, ρ in
    [0.05, 1.15) so that some individuals diverge."""

    def __init__(self, problem, canonical):
        self.problem = problem
        self._canonical = canonical
        self.group_calls = 0

    dimension = property(lambda self: self.problem.dimension)
    finest_grid = property(lambda self: self.problem.finest_grid)
    min_level = property(lambda self: self.problem.min_level)
    max_level = property(lambda self: self.problem.max_level)
    equations = property(lambda self: self.problem.equations)
    operators = property(lambda self: self.problem.operators)
    fields = property(lambda self: self.problem.fields)

    def uses_FAS(self):
        return False

    def initialize_code_generation(self, min_level, max_level, iteration_limit=None):
        pass

    def reinitialize(self, min_level, max_level, level_offset=0):
        self.problem = self.problem.with_levels(min_level, max_level)

    def generate_and_evaluate(self, expression, infinity=INFINITY, evaluation_samples=3,
                              global_variable_values=None, **_):
        digest = hashlib.sha256(self._canonical(expression).encode()).digest()
        rho = 0.05 + 1.1 * digest[0] / 256
        if rho >= 1.0:
            return infinity, rho, 500
        iterations = int(math.ceil(math.log(1e-12) / math.log(rho)))
        return iterations * (0.1 + digest[1] / 64), rho, iterations

    def generate_and_evaluate_group(self, expressions, infinity=INFINITY, evaluation_samples=3,
                                    global_variable_values=None):
        self.group_calls += 1
        return [self.generate_and_evaluate(e, infinity) for e in expressions]


def _evolve(side, method, tmp_path, min_level, max_level, seed, **kwargs):
    if side == "jax":
        problem = jax_poisson_2d(min_level, max_level, dtype=jnp.float64)
        generator = StubGenerator(problem, jax_canonical_string)
        optimizer_class = JaxOptimizer
    else:
        problem = poisson_2d(min_level, max_level, dtype=torch.float64)
        generator = StubGenerator(problem, canonical_string)
        optimizer_class = Optimizer
    optimizer = optimizer_class.for_problem(
        problem, program_generator=generator,
        checkpoint_directory_path=str(tmp_path / side), rng=random.Random(seed),
    )
    settings = dict(mu_=4, lambda_=4, population_initialization_factor=2, generations=2,
                    generalization_interval=100, evaluation_samples=1,
                    maximum_local_system_size=4, verbose=False)
    settings.update(kwargs)
    best, program, pops, logbooks, hofs = optimizer.evolutionary_optimization(
        optimization_method=getattr(optimizer, method), **settings)
    return {
        "best": best,
        "program": program,
        "populations": [[(str(i), i.fitness_values) for i in pop] for pop in pops],
        "halls_of_fame": [[(str(i), i.fitness_values) for i in hof] for hof in hofs],
        # gen_s is wall-clock seconds, the one field that may differ.
        "logbooks": [[{k: v for k, v in record.items() if k != "gen_s"} for record in lb.records]
                     for lb in logbooks],
        "levels": generator.problem.max_level,
        "group_calls": generator.group_calls,
    }


def _textbook_seeds(omega_indices):
    """V(2,1) textbook cycles at levels 3-5 that differ only in ω: one
    same-structure group in generation 0, so the optimizer's group path
    runs whatever the rng breeds."""
    problem = poisson_2d(3, 5, dtype=torch.float64)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=2, maximum_local_system_size=4)
    return [textbook_cycle_string(terminals, 2, 1, omega_index=i) for i in omega_indices]


GROUPING = dict(mu_=8, lambda_=8, generations=4, seed_individuals=_textbook_seeds((12, 16, 20)))
CASES = {
    "sogp": ("SOGP", 3, 5, 7, GROUPING),
    "nsga2": ("NSGAII", 3, 5, 4, GROUPING),
    "nsga3": ("NSGAIII", 3, 5, 7, GROUPING),
    "nsga2_two_runs": ("NSGAII", 3, 7, 6, dict(levels_per_run=2, generations=1)),
    "sogp_two_runs": ("SOGP", 3, 7, 9, dict(levels_per_run=2, generations=1)),
    "sogp_ramp": ("SOGP", 3, 4, 7, dict(generalization_interval=1, generations=2,
                                         population_initialization_factor=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ea_logic_matches_reference(case, tmp_path):
    method, min_level, max_level, seed, kwargs = CASES[case]
    expected = _evolve("jax", method, tmp_path, min_level, max_level, seed, **kwargs)
    got = _evolve("torch", method, tmp_path, min_level, max_level, seed, **kwargs)
    assert got == expected
    assert got["populations"] and all(got["populations"])
    if "levels_per_run" in kwargs:
        assert len(got["halls_of_fame"]) == 2
        assert "# level range [3, 5]" in got["program"] and "# level range [5, 7]" in got["program"]
    if kwargs.get("generalization_interval") == 1:
        assert got["levels"] == max_level + 1
    if kwargs is GROUPING:
        assert got["group_calls"] > 0


def test_model_based_fitness_is_not_ported(tmp_path):
    """The model-based fitness and tree drawing are ported now: the LFA ρ
    and the roofline time of a tree, and its DOT file."""
    from evostencils_torch.models.lfa import ConvergenceEvaluator
    from evostencils_torch.models.roofline import PerformanceEvaluator

    problem = poisson_2d(5, 6, dtype=torch.float64)
    optimizer = Optimizer.for_problem(
        problem, program_generator=StubGenerator(problem, canonical_string),
        convergence_evaluator=ConvergenceEvaluator(
            2, problem.coarsening_factors, problem.finest_grid, samples_per_axis=4),
        performance_evaluator=PerformanceEvaluator(),
        checkpoint_directory_path=str(tmp_path))
    pset, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=1, maximum_local_system_size=4)
    optimizer._pset = pset
    from evostencils_torch.grammar import gp

    tree = gp.parse_tree(textbook_cycle_string(terminals, 2, 2, omega_index=20), pset)
    rho, runtime_ms = optimizer.estimate_multiple_objectives(tree)
    assert 0.0 < rho < 0.2 and runtime_ms > 0.0
    optimizer.clear_individual_cache()
    single = optimizer.estimate_single_objective(gp.parse_tree(str(tree), pset))
    assert single[0] == pytest.approx(math.log(1e-12) / math.log(rho) * runtime_ms, rel=1e-12)
    Optimizer.visualize_tree(tree, str(tmp_path / "tree"))
    assert (tmp_path / "tree.dot").read_text().startswith("digraph derivation {")


def _cpu_optimizer(seed, ckpt):
    problem = poisson_2d(min_level=3, max_level=7, dtype=torch.float64)
    generator = TorchProgramGenerator(
        problem, dtype=torch.float64, iteration_limit=100, device="cpu")
    return Optimizer.for_problem(problem, program_generator=generator,
                                 checkpoint_directory_path=ckpt, rng=random.Random(seed))


class TestMultiRun:
    def test_levels_per_run_chains_coarse_solvers(self, tmp_path):
        opt = _cpu_optimizer(9, str(tmp_path))
        best, program, pops, logs, hofs = opt.evolutionary_optimization(
            mu_=4, lambda_=4, population_initialization_factor=2, generations=1,
            generalization_interval=100, optimization_method=opt.SOGP,
            evaluation_samples=1, maximum_local_system_size=4,
            levels_per_run=2, verbose=False,
        )
        assert len(hofs) == 2  # coarsest-first, then finest
        assert "# level range [3, 5]" in program
        assert "# level range [5, 7]" in program
        # The finest run's coarse-grid solver is the previous run's cycle.
        assert hofs[-1][0].fitness_values[0] < 1e50


class TestCheckpointResume:
    def test_resume_across_levels_per_run_boundary(self, tmp_path):
        settings = dict(
            mu_=4, lambda_=4, population_initialization_factor=2, generations=2,
            generalization_interval=100, evaluation_samples=1, maximum_local_system_size=4,
            levels_per_run=2, checkpoint_frequency=1, verbose=False,
        )
        opt = _cpu_optimizer(11, str(tmp_path))
        _, program, _, _, hofs = opt.evolutionary_optimization(
            optimization_method=opt.SOGP, **settings)
        assert len(hofs) == 2
        coarse_entry = program.split("# level range [5, 7]")[0]
        assert coarse_entry.startswith("# level range [3, 5]")

        opt2 = _cpu_optimizer(77, str(tmp_path))
        _, program2, _, _, hofs2 = opt2.evolutionary_optimization(
            optimization_method=opt2.SOGP, continue_from_checkpoint=True, **settings)
        # Only the finest run ran again: the coarser one was restored from
        # the checkpoint's program (another seed would evolve another tree).
        assert len(hofs2) == 1
        assert program2.startswith(coarse_entry)
        assert "# level range [5, 7]" in program2
        assert hofs2[-1][0].fitness_values[0] < 1e50


def test_entry_points_default_to_the_card():
    problem = poisson_2d(3, 5)
    assert TorchProgramGenerator(problem).device.type == "cuda"
    assert CycleLowering(torch.float32).device.type == "cuda"
    assert CycleLowering(torch.float32).use_kernels


def test_named_problems():
    """Every name of the reference's registry builds the reference's
    (name, min_level, max_level); a problem file loads by its extension."""
    from evostencils_tpu.problems import build_named_problem as jax_build_named_problem

    for name in ("poisson2d", "poisson3d", "poisson2d_var", "elasticity", "helmholtz", "fas"):
        for levels in ((), (3, 5), (5, 9), (4, 10)):
            problem = build_named_problem(name, *levels)
            reference = jax_build_named_problem(name, *levels)
            assert (problem.name, problem.min_level, problem.max_level) == (
                reference.name, reference.min_level, reference.max_level), (name, levels)
    with pytest.raises(ValueError):
        build_named_problem("no_such_problem")
    problem = load_problem_file(
        os.path.join(ROOT, "artifacts", "problem_specs", "2D_FD_Helmholtz_fromL3.exa3"))
    assert (problem.min_level, problem.max_level, problem.dtype) == (3, 7, torch.complex64)
    with pytest.raises(ValueError):
        load_problem_file("spec.exa")


FAMILY_LEVELS = {
    # build_named_problem's mapping: 3D runs two levels lower (2-4 here).
    "poisson3d": ("4", "4"),
    "poisson2d_var": ("3", "5"),
    "elasticity": ("3", "5"),
    "fas": ("3", "5"),
}


@pytest.mark.parametrize("name", sorted(FAMILY_LEVELS))
def test_evolution_entry_point_runs_every_family(name, tmp_path, monkeypatch):
    """scripts/torch_optimize.py --cpu, one generation with μ = λ = 2.  FAS
    keeps its own levels 5-9 in the registry, as in the reference, so the
    test builds it at 3-5 instead."""
    from evostencils_torch.problems import fas
    from scripts import torch_optimize

    if name == "fas":
        monkeypatch.setattr(torch_optimize, "build_named_problem",
                            lambda *args: fas.fas_2d(3, 5))
    lo, hi = FAMILY_LEVELS[name]
    run = torch_optimize.run([
        "--cpu", "--problem", name, "--min-level", lo, "--max-level", hi, "--method", "sogp",
        "--mu", "2", "--lambda", "2", "--generations", "1", "--evaluation-samples", "1",
        "--seed", "2", "--output", str(tmp_path)])
    assert run.generator.uses_FAS() == (name == "fas")
    assert run.optimizer._total_number_of_evaluations >= 2
    assert (tmp_path / "program.txt").is_file() and (tmp_path / "individual_0.txt").is_file()
