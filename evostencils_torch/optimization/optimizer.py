"""Evolutionary optimizer: (μ+λ) G3P over multigrid grammars (the port of
evostencils_tpu/optimization/optimizer.py).

The evolutionary logic is the reference's, line for line: the same rng
draws, selection, caching, grouping, ramp and stitching, so with the same
fitness function both packages evolve the same populations.  What differs:
`for_problem` builds a `TorchProgramGenerator` on the card; a nested
coarse-grid solver starts from `torch.zeros_like`; the model-based fitness
takes the port's LFA model and its roofline with H100 constants
(models/); the program generator has no `precompile` hook (eager torch
compiles nothing).
Checkpoints pickle this package's classes, so they do not load in the
reference, nor the reference's here.

Feature parity with the original EvoStencils Optimizer
(optimization/program.py:67-958):
  * SOGP (single-objective, unique-best elitism, tournament-2 mating),
  * NSGA-II (crowded-comparison mating), NSGA-III (reference points),
  * optional pure random search,
  * per-individual fitness cache keyed by the canonical tree string,
  * offspring retry loop (≤10 tries avoiding cached/oversized children),
  * generalization ramp (problem-size growth every
    `generalization_interval` generations, with PDE-parameter ladders),
  * checkpoint/resume every `checkpoint_frequency` generations,
  * multi-run level splitting (`levels_per_run`) where each run's best
    cycle becomes the coarse-grid solver expression of the next run,
  * hall-of-fame / Pareto archives + per-generation logbooks.
"""

from __future__ import annotations

import math
import os
import pickle
import random
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from evostencils_torch.grammar import gp
from evostencils_torch.grammar import multigrid as mg_grammar
from evostencils_torch.ir import system
from evostencils_torch.optimization import selection
from evostencils_torch.utils.logbook import (
    HallOfFame,
    Logbook,
    MultiStatistics,
    ParetoFront,
    Statistics,
)


class CheckPoint:
    """Durable EA state (reference optimization/program.py:47-64)."""

    def __init__(self, min_level, max_level, generation, program, solver_string,
                 population_strings, fitnesses, logbooks):
        self.min_level = min_level
        self.max_level = max_level
        self.generation = generation
        self.program = program
        self.solver_string = solver_string
        self.population_strings = population_strings
        self.fitnesses = fitnesses
        self.logbooks = logbooks

    def dump_to_file(self, path):
        with open(path, "wb") as f:
            pickle.dump(self, f)


def load_checkpoint_from_file(path) -> CheckPoint:
    with open(path, "rb") as f:
        return pickle.load(f)


class NestedCycleSolver:
    """Adapter: an evolved cycle from a previous run used as the coarse-grid
    solver of the next run (multi-run level splitting).  Applying it runs
    the cycle once on (u=0, f=r) — the analog of the reference's
    `gen_mgCycle@coarser()` call emitted for CoarseGridSolver
    (reference code_generation/exastencils.py:896)."""

    def __init__(self, expression, iterations: int = 1):
        self.expression = expression
        self.iterations = iterations

    def apply_as_solver(self, lowering, r_state):
        step = lowering.lower(self.expression)
        u = tuple(torch.zeros_like(r) for r in r_state)
        for _ in range(self.iterations):
            u = step(u, tuple(r_state))
        return u


class Optimizer:
    # Added to every non-converged single-objective fitness: far above any
    # real time-to-convergence in ms (≈ 11.6 days), far below `infinity`
    # (1e100), so failures sort after all successes but keep their
    # √(ρ·iters) relative order.
    FAILURE_FITNESS_OFFSET = 1e9

    def __init__(
        self,
        dimension,
        finest_grid,
        coarsening_factor,
        min_level,
        max_level,
        equations,
        operators,
        fields,
        program_generator,
        convergence_evaluator=None,
        performance_evaluator=None,
        checkpoint_directory_path="./checkpoints",
        epsilon=1e-12,
        infinity=1e100,
        individual_cache_size=100000,
        rng: Optional[random.Random] = None,
    ):
        self._dimension = dimension
        self._finest_grid = finest_grid
        self._coarsening_factor = coarsening_factor
        self._min_level = min_level
        self._max_level = max_level
        self._equations = equations
        self._operators = operators
        self._fields = fields
        self._program_generator = program_generator
        self._convergence_evaluator = convergence_evaluator
        self._performance_evaluator = performance_evaluator
        self._checkpoint_directory_path = checkpoint_directory_path
        self._epsilon = epsilon
        self._infinity = infinity
        self.rng = rng or random.Random()

        from evostencils_torch.ir import base as ir_base

        self._approximation = system.Approximation(
            "u", [ir_base.Approximation(str(fields[i]), g) for i, g in enumerate(finest_grid)]
        )
        self._rhs = system.RightHandSide(
            "f", [ir_base.RightHandSide(f"{fields[i]}_rhs", g) for i, g in enumerate(finest_grid)]
        )

        self._individual_cache = {}
        self._individual_cache_size = individual_cache_size
        self._individual_cache_hits = 0
        self._individual_cache_misses = 0
        self._failed_evaluations = 0
        self._total_number_of_evaluations = 0
        self._total_evaluation_time = 0.0
        self._pset = None

    @classmethod
    def for_problem(cls, problem, program_generator=None, **kwargs):
        from evostencils_torch.backend.evaluation import TorchProgramGenerator

        generator = program_generator or TorchProgramGenerator(problem)
        return cls(
            problem.dimension,
            problem.finest_grid,
            problem.coarsening_factors,
            problem.min_level,
            problem.max_level,
            problem.equations,
            problem.operators,
            problem.fields,
            generator,
            **kwargs,
        )

    # ---- properties mirroring the reference surface ----

    @property
    def approximation(self):
        return self._approximation

    @property
    def rhs(self):
        return self._rhs

    @property
    def dimension(self):
        return self._dimension

    @property
    def finest_grid(self):
        return self._finest_grid

    @property
    def coarsening_factors(self):
        return self._coarsening_factor

    @property
    def min_level(self):
        return self._min_level

    @property
    def max_level(self):
        return self._max_level

    @property
    def equations(self):
        return self._equations

    @property
    def operators(self):
        return self._operators

    @property
    def fields(self):
        return self._fields

    @property
    def program_generator(self):
        return self._program_generator

    @property
    def convergence_evaluator(self):
        return self._convergence_evaluator

    @property
    def performance_evaluator(self):
        return self._performance_evaluator

    @property
    def epsilon(self):
        return self._epsilon

    @property
    def infinity(self):
        return self._infinity

    # ---- fitness cache (reference program.py:188-204) ----

    def clear_individual_cache(self):
        self._individual_cache.clear()

    def add_individual_to_cache(self, individual, values):
        if len(self._individual_cache) < self._individual_cache_size:
            self._individual_cache[str(individual)] = values

    def individual_in_cache(self, individual) -> bool:
        hit = str(individual) in self._individual_cache
        if hit:
            self._individual_cache_hits += 1
        else:
            self._individual_cache_misses += 1
        return hit

    def get_cached_fitness(self, individual):
        return self._individual_cache[str(individual)]

    # ---- individual construction ----

    def compile_individual(self, individual, pset=None):
        return gp.compile_tree(individual, pset or self._pset)

    def _generate_individual(self):
        return gp.gen_grow(self._pset, 0, 50, rng=self.rng)

    def _rebuild_pset(self):
        """Reconstruct the primitive set against the program generator's
        *current* problem (used by the generalization ramp)."""
        from evostencils_torch.ir import base as ir_base

        cfg = self._grammar_config
        pg = self._program_generator
        finest_grid = pg.finest_grid
        approximation = system.Approximation(
            "u",
            [
                ir_base.Approximation(str(f), g)
                for f, g in zip(pg.fields, finest_grid)
            ],
        )
        rhs = system.RightHandSide(
            "f",
            [
                ir_base.RightHandSide(f"{f}_rhs", g)
                for f, g in zip(pg.fields, finest_grid)
            ],
        )
        pset, _ = mg_grammar.generate_primitive_set(
            approximation,
            rhs,
            self.dimension,
            self.coarsening_factors,
            pg.max_level,
            pg.equations,
            pg.operators,
            pg.fields,
            **cfg,
        )
        self._pset = pset

    def _population(self, n):
        return [self._generate_individual() for _ in range(n)]

    def _mutate(self, individual):
        if self.rng.random() < self._node_replacement_probability:
            return gp.mut_node_replacement(individual, self._pset, rng=self.rng)
        return gp.mutate_subtree(individual, 0, 10, self._pset, rng=self.rng)

    # ---- fitness functions (reference program.py:319-453) ----

    def estimate_single_objective(self, individual):
        if self.individual_in_cache(individual):
            return self.get_cached_fitness(individual)
        self._total_number_of_evaluations += 1
        try:
            expression, _ = self.compile_individual(individual)
        except (MemoryError, RuntimeError):
            self._failed_evaluations += 1
            values = (self.infinity,)
            self.add_individual_to_cache(individual, values)
            return values
        rho = self.convergence_evaluator.compute_spectral_radius(expression)
        if rho == 0.0 or math.isnan(rho) or math.isinf(rho):
            values = (self.infinity,)
        elif self.performance_evaluator is None:
            values = (rho,)
        elif rho < 1:
            runtime = self.performance_evaluator.estimate_runtime(expression) * 1e3
            values = (math.log(self.epsilon) / math.log(rho) * runtime,)
        else:
            values = (rho * self.infinity**0.25,)
        self.add_individual_to_cache(individual, values)
        return values

    def estimate_multiple_objectives(self, individual):
        if self.individual_in_cache(individual):
            return self.get_cached_fitness(individual)
        self._total_number_of_evaluations += 1
        try:
            expression, _ = self.compile_individual(individual)
        except (MemoryError, RuntimeError):
            self._failed_evaluations += 1
            values = (self.infinity, self.infinity)
            self.add_individual_to_cache(individual, values)
            return values
        rho = self.convergence_evaluator.compute_spectral_radius(expression)
        if rho == 0.0 or math.isnan(rho) or math.isinf(rho):
            self._failed_evaluations += 1
            values = (self.infinity, self.infinity)
        else:
            runtime = self.performance_evaluator.estimate_runtime(expression) * 1e3
            values = (rho, runtime)
        self.add_individual_to_cache(individual, values)
        return values

    def evaluate_single_objective(self, individual, evaluation_samples=3,
                                  pde_parameter_values=None):
        if len(individual) > 150:
            return (self.infinity,)
        if self.individual_in_cache(individual):
            return self.get_cached_fitness(individual)
        try:
            expression, _ = self.compile_individual(individual)
        except (MemoryError, RuntimeError):
            self._failed_evaluations += 1
            fitness = (self.infinity,)
            self.add_individual_to_cache(individual, fitness)
            return fitness
        start = time.time()
        t, rho, iterations = self._program_generator.generate_and_evaluate(
            expression,
            infinity=self.infinity,
            evaluation_samples=evaluation_samples,
            global_variable_values=pde_parameter_values or {},
        )
        self._total_number_of_evaluations += 1
        self._total_evaluation_time += time.time() - start
        fitness = (t,)
        if not math.isfinite(t) or t >= self.infinity:
            # √(ρ·iters) fallback for non-converged individuals using the
            # *measured* convergence factor and iteration count (reference
            # program.py:414-415 with parse_output's executed count) — so
            # failures are ordered by both contraction and work.  The
            # offset keeps every failure strictly worse than any converged
            # time-to-convergence (ms): without it, a capped Helmholtz
            # outer solve (√(0.99·600) ≈ 24) would outrank a converged one
            # (t ≈ 3600 ms) and SOGP would select for divergence.
            fitness = (
                self.FAILURE_FITNESS_OFFSET
                + min(rho, self.infinity) ** 0.5
                * min(iterations, self.infinity) ** 0.5,
            )
        self.add_individual_to_cache(individual, fitness)
        return fitness

    def evaluate_multiple_objectives(self, individual, evaluation_samples=3,
                                     pde_parameter_values=None):
        if len(individual) > 150:
            return (self.infinity, self.infinity)
        if self.individual_in_cache(individual):
            return self.get_cached_fitness(individual)
        try:
            expression, _ = self.compile_individual(individual)
        except (MemoryError, RuntimeError):
            self._failed_evaluations += 1
            fitness = (self.infinity, self.infinity)
            self.add_individual_to_cache(individual, fitness)
            return fitness
        start = time.time()
        t, rho, iterations = self._program_generator.generate_and_evaluate(
            expression,
            infinity=self.infinity,
            evaluation_samples=evaluation_samples,
            global_variable_values=pde_parameter_values or {},
        )
        self._total_number_of_evaluations += 1
        self._total_evaluation_time += time.time() - start
        if not math.isfinite(t) or t >= self.infinity:
            fitness = (rho, self.infinity)
        else:
            fitness = (rho, t / iterations)
        self.add_individual_to_cache(individual, fitness)
        return fitness

    def _measurement_to_fitness(self, t, rho, iterations):
        """Fitness rules shared by single and batched measured evaluation
        (reference program.py:413-415, 449-451)."""
        if self._n_objectives == 2:
            if not math.isfinite(t) or t >= self.infinity:
                return (rho, self.infinity)
            return (rho, t / iterations)
        if not math.isfinite(t) or t >= self.infinity:
            # Same offset as evaluate_single_objective: every failure must
            # rank strictly worse than any converged time-to-convergence,
            # or grouped SOGP evaluation selects for divergence.
            return (
                self.FAILURE_FITNESS_OFFSET
                + min(rho, self.infinity) ** 0.5
                * min(iterations, self.infinity) ** 0.5,
            )
        return (t,)

    def _evaluate_population(self, individuals, evaluate: Callable,
                             evaluation_samples=3, pde_parameter_values=None):
        """Evaluate all invalid individuals.

        Same-structure individuals (offspring that differ only in their
        relaxation factors ω) evaluate as one group through
        program_generator.generate_and_evaluate_group; the rest run
        serially (reference program.py:478-502)."""
        from evostencils_torch.ir.transformations import canonical_string

        invalid = [ind for ind in individuals if ind.fitness_values is None]

        groups = {}
        singles = []
        can_group = (
            getattr(self, "_measured_evaluation", False)
            and hasattr(self._program_generator, "generate_and_evaluate_group")
        )
        for ind in invalid:
            if len(ind) > 150 or self.individual_in_cache(ind):
                singles.append(ind)
                continue
            try:
                expr, _ = self.compile_individual(ind)
            except (MemoryError, RuntimeError):
                singles.append(ind)
                continue
            if can_group:
                key = canonical_string(expr, parameterize_relaxation=True)
                groups.setdefault(key, []).append((ind, expr))
            else:
                singles.append(ind)

        for key, members in list(groups.items()):
            if len(members) == 1:
                singles.append(members[0][0])
                continue
            measurements = self._program_generator.generate_and_evaluate_group(
                [expr for _, expr in members],
                infinity=self.infinity,
                evaluation_samples=evaluation_samples,
                global_variable_values=pde_parameter_values or {},
            )
            for (ind, _), (t, rho, iterations) in zip(members, measurements):
                fitness = self._measurement_to_fitness(t, rho, iterations)
                self._total_number_of_evaluations += 1
                self.add_individual_to_cache(ind, fitness)
                ind.fitness_values = tuple(fitness)

        for ind in singles:
            fit = evaluate(ind)
            ind.fitness_values = tuple(fit)
            self.add_individual_to_cache(ind, tuple(fit))
        return len(invalid)

    # ---- the (μ+λ) generational engine (reference program.py:455-625) ----

    def ea_mu_plus_lambda(
        self,
        evaluate: Callable,
        select: Callable,
        select_for_mating: Callable,
        initial_population_size: int,
        generations: int,
        generalization_interval: int,
        mu_: int,
        lambda_: int,
        crossover_probability: float,
        mutation_probability: float,
        min_level: int,
        max_level: int,
        evaluation_samples: int,
        logbooks: List[Logbook],
        pde_parameter_values: dict,
        checkpoint_frequency: int,
        checkpoint: Optional[CheckPoint],
        mstats: MultiStatistics,
        hof,
        use_random_search: bool,
        solver_program: str = "",
        verbose: bool = True,
        seed_individuals=None,
    ):
        mstats.register("avg", np.mean)
        mstats.register("std", np.std)
        mstats.register("min", np.min)
        mstats.register("max", np.max)

        use_checkpoint = False
        if checkpoint is not None:
            if mu_ == len(checkpoint.population_strings):
                use_checkpoint = True
            else:
                print(
                    f"Could not restart from checkpoint: population size "
                    f"{len(checkpoint.population_strings)} != μ {mu_}",
                    flush=True,
                )
        if use_checkpoint:
            population = []
            for s, fit in zip(checkpoint.population_strings, checkpoint.fitnesses):
                tree = gp.parse_tree(s, self._pset)
                tree.fitness_values = tuple(fit) if fit is not None else None
                population.append(tree)
            min_generation = checkpoint.generation
            logbook = checkpoint.logbooks[-1]
            logbooks.extend(checkpoint.logbooks)
        else:
            population = self._population(initial_population_size)
            # Seed known-good shapes (grammar strings) into the initial
            # population: they compete from generation 0 and their subtrees
            # spread through crossover (reference-scale random search,
            # μ=λ=128×150, is what they substitute for).
            for s in seed_individuals or []:
                try:
                    population.insert(0, gp.parse_tree(s, self._pset))
                except (KeyError, ValueError, RuntimeError, IndexError) as e:
                    # IndexError: parse_tree walking past the token list on
                    # a truncated grammar string (hand-edited artifact).
                    print(f"Seed individual rejected: {e!r}", flush=True)
            min_generation = 0
            logbook = Logbook()
            logbooks.append(logbook)

        current_parameters = {
            key: values[0] for key, values in pde_parameter_values.items()
        }
        gen_t0 = time.perf_counter()
        nevals = self._evaluate_population(
            population,
            lambda ind: evaluate(
                ind,
                evaluation_samples=evaluation_samples,
                pde_parameter_values=current_parameters,
            ),
            evaluation_samples=evaluation_samples,
            pde_parameter_values=current_parameters,
        )
        population = select(population, min(mu_, len(population)))
        hof.update(population)
        record = mstats.compile(population)
        # gen_s: wall seconds per generation — the paper-protocol scaling
        # claim (per-individual cost flat in population size) is checked
        # against this curve.
        logbook.record(
            gen=min_generation, nevals=nevals,
            gen_s=round(time.perf_counter() - gen_t0, 1), **record,
        )
        if verbose:
            print(logbook.stream, flush=True)

        count = 0
        level_offset = 0
        evaluation_min_level, evaluation_max_level = min_level, max_level
        for gen in range(min_generation + 1, generations + 1):
            gen_t0 = time.perf_counter()
            if count >= generalization_interval:
                # Generalization: grow the problem size and re-evaluate
                # (reference program.py:515-539).
                level_offset += 1
                evaluation_min_level = min_level + level_offset
                evaluation_max_level = max_level + level_offset
                current_parameters = {}
                for key, values in pde_parameter_values.items():
                    assert level_offset < len(values), "Too few parameter values"
                    current_parameters[key] = values[level_offset]
                count = 0
                if verbose:
                    print("Increasing problem size", flush=True)
                self._program_generator.reinitialize(
                    evaluation_min_level, evaluation_max_level, level_offset
                )
                # Rebuild the grammar at the shifted levels and re-parse
                # the population against it: production/terminal names are
                # depth-based (level-independent within a run), so the
                # trees transfer verbatim — the analog of the reference
                # re-emitting the same trees with shifted knowledge files
                # (reference program.py:515-539, exastencils.py:196-215).
                self._rebuild_pset()
                population = [
                    gp.parse_tree(str(ind), self._pset) for ind in population
                ]
                self.clear_individual_cache()
                hof.clear()
                for ind in population:
                    ind.fitness_values = None
                self._evaluate_population(
                    population,
                    lambda ind: evaluate(
                        ind,
                        evaluation_samples=evaluation_samples,
                        pde_parameter_values=current_parameters,
                    ),
                    evaluation_samples=evaluation_samples,
                    pde_parameter_values=current_parameters,
                )
                population = select(population, min(mu_, len(population)))
                hof.update(population)

            if use_random_search:
                offspring = self._population(lambda_)
            else:
                n_parents = lambda_ + (lambda_ % 2)
                parents = []
                for src in select_for_mating(population, n_parents):
                    p = src.copy()
                    p.fitness_values = src.fitness_values
                    if hasattr(src, "crowding_distance"):
                        p.crowding_distance = src.crowding_distance
                    parents.append(p)
                offspring = []
                for ind1, ind2 in zip(parents[::2], parents[1::2]):
                    child1 = child2 = None
                    tries = 0
                    while tries < 10 and (
                        child1 is None
                        or len(child1) > 150
                        or self.individual_in_cache(child1)
                        or child2 is None
                        or len(child2) > 150
                        or self.individual_in_cache(child2)
                    ):
                        choice = self.rng.random()
                        if choice < crossover_probability:
                            child1, child2 = gp.cx_one_point(
                                ind1.copy(), ind2.copy(), rng=self.rng
                            )
                        elif choice < crossover_probability + mutation_probability + 1e-9:
                            (child1,) = self._mutate(ind1.copy())
                            (child2,) = self._mutate(ind2.copy())
                        else:
                            child1, child2 = ind1.copy(), ind2.copy()
                        tries += 1
                    child1.fitness_values = None
                    child2.fitness_values = None
                    offspring.append(child1)
                    if len(offspring) == lambda_:
                        break
                    offspring.append(child2)
                    if len(offspring) == lambda_:
                        break

            nevals = self._evaluate_population(
                offspring,
                lambda ind: evaluate(
                    ind,
                    evaluation_samples=evaluation_samples,
                    pde_parameter_values=current_parameters,
                ),
                evaluation_samples=evaluation_samples,
                pde_parameter_values=current_parameters,
            )
            hof.update(offspring)

            # (μ+λ) elitist selection
            population = select(population, min(mu_, len(population)))
            population = select(population + offspring, mu_)

            if checkpoint_frequency and gen % checkpoint_frequency == 0:
                # AFTER selection: the checkpoint labeled generation g must
                # contain g's surviving offspring, or resume silently
                # discards λ evaluated individuals (elitism makes the
                # merged population a superset of the all-time best μ).
                self._write_checkpoint(
                    min_level, max_level, gen, solver_program, population, logbooks
                )
            count += 1
            record = mstats.compile(population)
            logbook.record(
                gen=gen, nevals=nevals,
                gen_s=round(time.perf_counter() - gen_t0, 1), **record,
            )
            if verbose:
                print(logbook.stream, flush=True)

        hof.update(population)
        return population, logbook, hof, evaluation_min_level, evaluation_max_level

    def _write_checkpoint(self, min_level, max_level, gen, solver_program,
                          population, logbooks):
        checkpoint = CheckPoint(
            min_level,
            max_level,
            gen,
            solver_program,
            getattr(self, "_coarse_solver_string", None),
            [str(ind) for ind in population],
            [ind.fitness_values for ind in population],
            logbooks,
        )
        try:
            os.makedirs(self._checkpoint_directory_path, exist_ok=True)
            checkpoint.dump_to_file(
                os.path.join(self._checkpoint_directory_path, "checkpoint.p")
            )
        except (pickle.PickleError, TypeError, FileNotFoundError) as e:
            print(f"Skipping checkpoint: {e}", flush=True)

    # ---- optimization method front-ends (reference program.py:627-768) ----

    def _make_mstats(self, objectives: int) -> MultiStatistics:
        if objectives == 1:
            return MultiStatistics(
                fitness=Statistics(lambda ind: ind.fitness_values[0]),
                size=Statistics(len),
            )
        return MultiStatistics(
            convergence_factor=Statistics(lambda ind: ind.fitness_values[0]),
            execution_time=Statistics(lambda ind: ind.fitness_values[1]),
            size=Statistics(len),
        )

    def SOGP(self, model_based_estimation=False, **kwargs):
        self._n_objectives = 1
        self._measured_evaluation = not model_based_estimation
        evaluate = (
            (lambda ind, evaluation_samples=3, pde_parameter_values=None:
             self.estimate_single_objective(ind))
            if model_based_estimation
            else self.evaluate_single_objective
        )
        hof = HallOfFame(2 * kwargs["mu_"])
        return self.ea_mu_plus_lambda(
            evaluate=evaluate,
            select=lambda pop, k: gp.select_unique_best(pop, k),
            select_for_mating=lambda pop, k: selection.sel_tournament(
                pop, k, tournsize=2, rng=self.rng
            ),
            mstats=self._make_mstats(1),
            hof=hof,
            **kwargs,
        )

    def NSGAII(self, model_based_estimation=False, **kwargs):
        self._n_objectives = 2
        self._measured_evaluation = not model_based_estimation
        evaluate = (
            (lambda ind, evaluation_samples=3, pde_parameter_values=None:
             self.estimate_multiple_objectives(ind))
            if model_based_estimation
            else self.evaluate_multiple_objectives
        )

        def select_for_mating(pop, k):
            if k % 4 > 0:
                k += 4 - k % 4
            return selection.sel_tournament_dcd(pop, k, rng=self.rng)

        hof = ParetoFront()
        return self.ea_mu_plus_lambda(
            evaluate=evaluate,
            select=lambda pop, k: selection.sel_nsga2(pop, k, rng=self.rng),
            select_for_mating=select_for_mating,
            mstats=self._make_mstats(2),
            hof=hof,
            **kwargs,
        )

    def NSGAIII(self, model_based_estimation=False, **kwargs):
        self._n_objectives = 2
        self._measured_evaluation = not model_based_estimation
        evaluate = (
            (lambda ind, evaluation_samples=3, pde_parameter_values=None:
             self.estimate_multiple_objectives(ind))
            if model_based_estimation
            else self.evaluate_multiple_objectives
        )
        ref_points = selection.uniform_reference_points(2, kwargs["mu_"])
        hof = ParetoFront()
        return self.ea_mu_plus_lambda(
            evaluate=evaluate,
            select=lambda pop, k: selection.sel_nsga3(pop, k, ref_points, rng=self.rng),
            select_for_mating=lambda pop, k: selection.sel_random(pop, k, rng=self.rng),
            mstats=self._make_mstats(2),
            hof=hof,
            **kwargs,
        )

    # ---- the multi-run loop (reference program.py:770-902) ----

    def evolutionary_optimization(
        self,
        mu_=128,
        lambda_=128,
        population_initialization_factor=4,
        generations=150,
        generalization_interval=50,
        crossover_probability=0.7,
        mutation_probability=0.3,
        node_replacement_probability=1.0 / 3.0,
        optimization_method=None,
        use_random_search=False,
        levels_per_run=None,
        evaluation_samples=3,
        continue_from_checkpoint=False,
        maximum_local_system_size=8,
        model_based_estimation=False,
        pde_parameter_values=None,
        checkpoint_frequency=2,
        verbose=False,
        seed_individuals=None,
    ):
        if pde_parameter_values is None:
            pde_parameter_values = {}
        self._node_replacement_probability = node_replacement_probability
        levels = self.max_level - self.min_level
        if levels_per_run is None:
            levels_per_run = levels
        if levels_per_run < levels and generalization_interval < generations:
            print("Stepwise generalization only supported for single-stage runs; "
                  "adapting generalization interval.", flush=True)
            generalization_interval = generations
        if model_based_estimation:
            levels_per_run = min(levels_per_run, 2)

        approximations = [self.approximation]
        right_hand_sides = [self.rhs]
        for _ in range(1, levels + 1):
            approximations.append(
                system.get_coarse_approximation(approximations[-1], self.coarsening_factors)
            )
            right_hand_sides.append(
                system.get_coarse_rhs(right_hand_sides[-1], self.coarsening_factors)
            )

        checkpoint = None
        checkpoint_path = os.path.join(self._checkpoint_directory_path, "checkpoint.p")
        if continue_from_checkpoint and os.path.isfile(checkpoint_path):
            try:
                checkpoint = load_checkpoint_from_file(checkpoint_path)
            except (pickle.PickleError, EOFError):
                checkpoint = None

        pops, logbooks, hofs = [], [], []
        best_individual = None
        solver_expression = None
        solver_program = ""
        if checkpoint is not None and getattr(checkpoint, "program", None):
            # Restore the accumulated multi-run program so resumed runs
            # re-stitch the already-evolved coarser cycles instead of
            # restarting from an empty program (reference
            # program.py:794-820).
            solver_program = checkpoint.program
        fas = self._program_generator.uses_FAS()
        coarse_solver_expression = None

        # Runs proceed coarsest-first: each run's evolved cycle becomes the
        # coarse-grid solver expression of the next (finer) run.  This is a
        # deliberate re-design of the reference's finest-first stitching
        # (reference program.py:810-899, where the coarse solver during
        # evolution is the ExaStencils *default* cycle and stitching happens
        # textually): evolving bottom-up gives every run its real coarse
        # solver, and the final solver is identical in structure.
        for i in reversed(range(0, levels, levels_per_run)):
            # Clamp the coarsest run when levels_per_run does not divide
            # the span: the last run just covers fewer levels instead of
            # reaching below the problem's min_level (grammar setup crash).
            min_level = max(self.max_level - (i + levels_per_run),
                            self.min_level)
            max_level = self.max_level - i
            approximation = approximations[i]
            rhs = right_hand_sides[i]
            if model_based_estimation and self.convergence_evaluator is not None:
                self.convergence_evaluator.reinitialize_lfa_grids(approximation.grid)
            enable_partitioning = not model_based_estimation

            self._grammar_config = dict(
                enable_partitioning=enable_partitioning,
                maximum_local_system_size=maximum_local_system_size,
                depth=max_level - min_level,
                coarse_grid_solver_expression=coarse_solver_expression,
                FAS=fas,
            )

            pass_checkpoint = False
            if checkpoint is not None:
                if min_level == checkpoint.min_level and max_level == checkpoint.max_level:
                    pass_checkpoint = True
                elif min_level < checkpoint.min_level:
                    # A coarser run that already completed before the
                    # checkpoint: re-parse its best individual from the
                    # accumulated program so it becomes this resume's
                    # coarse-grid solver, instead of re-evolving it
                    # (reference program.py:794-820).
                    restored = self._restore_completed_run(
                        solver_program, min_level, max_level, approximation, rhs
                    )
                    if restored is not None:
                        best_individual, solver_expression = restored
                        coarse_solver_expression = NestedCycleSolver(
                            solver_expression
                        )
                        continue
                    # No stored entry (pre-parity checkpoint): fall through
                    # and re-evolve this run.
            pset, _ = mg_grammar.generate_primitive_set(
                approximation,
                rhs,
                self.dimension,
                self.coarsening_factors,
                max_level,
                self.equations,
                self.operators,
                self.fields,
                **self._grammar_config,
            )
            self._pset = pset
            self._program_generator.initialize_code_generation(min_level, max_level)
            self.clear_individual_cache()
            # The previous run's best tree string, persisted in checkpoints
            # (reference CheckPoint.solver, program.py:47-64).
            self._coarse_solver_string = (
                str(best_individual) if best_individual is not None else None
            )
            method = optimization_method or self.NSGAII

            pop, log, hof, eval_min_level, eval_max_level = method(
                model_based_estimation=model_based_estimation,
                initial_population_size=population_initialization_factor * mu_,
                generations=generations,
                generalization_interval=generalization_interval,
                mu_=mu_,
                lambda_=lambda_,
                crossover_probability=crossover_probability,
                mutation_probability=mutation_probability,
                min_level=min_level,
                max_level=max_level,
                evaluation_samples=evaluation_samples,
                logbooks=logbooks,
                pde_parameter_values=pde_parameter_values,
                checkpoint_frequency=checkpoint_frequency,
                checkpoint=checkpoint if pass_checkpoint else None,
                use_random_search=use_random_search,
                solver_program=solver_program,
                verbose=verbose,
                # Seeds are authored against the full-depth grammar; only
                # single-run optimizations can consume them.
                seed_individuals=(
                    seed_individuals if levels_per_run >= levels else None
                ),
            )

            def scalar_time(ind):
                values = ind.fitness_values
                if len(values) == 2:
                    rho, t_iter = values
                    if rho < 1:
                        return math.log(self.epsilon) / math.log(rho) * t_iter
                    return rho * math.sqrt(self.infinity) * t_iter
                return values[0]

            ranked_hof = sorted(list(hof), key=scalar_time)
            pops.append(sorted(pop, key=scalar_time))
            hofs.append(ranked_hof)
            best_individual = ranked_hof[0]
            solver_expression, _ = self.compile_individual(best_individual, pset)
            solver_program += (
                f"# level range [{min_level}, {max_level}]\n{str(best_individual)}\n"
            )
            # The evolved cycle becomes the coarse-grid solver of the next
            # (coarser→finer stitching handled via CGS expression).
            coarse_solver_expression = NestedCycleSolver(solver_expression)

        return str(best_individual), solver_program, pops, logbooks, hofs

    def _restore_completed_run(self, solver_program, min_level, max_level,
                               approximation, rhs):
        """Re-parse a completed run's best individual from the accumulated
        program string (entries appended as ``# level range [a, b]`` +
        tree string by evolutionary_optimization).  Returns (tree,
        expression) or None when no entry for this level range exists."""
        marker = f"# level range [{min_level}, {max_level}]"
        lines = solver_program.splitlines()
        for idx, line in enumerate(lines):
            if line.strip() == marker and idx + 1 < len(lines):
                tree_string = lines[idx + 1].strip()
                if not tree_string:
                    return None
                pset, _ = mg_grammar.generate_primitive_set(
                    approximation,
                    rhs,
                    self.dimension,
                    self.coarsening_factors,
                    max_level,
                    self.equations,
                    self.operators,
                    self.fields,
                    **self._grammar_config,
                )
                tree = gp.parse_tree(tree_string, pset)
                expression, _ = gp.compile_tree(tree, pset)
                return tree, expression
        return None

    # ---- re-evaluation of stored individuals (reference program.py:904-933) ----

    def generate_and_evaluate_program_from_grammar_representation(
        self, grammar_string: str, maximum_block_size: int, evaluation_samples: int = 20
    ):
        levels = self.max_level - self.min_level
        pset, _ = mg_grammar.generate_primitive_set(
            self.approximation,
            self.rhs,
            self.dimension,
            self.coarsening_factors,
            self.max_level,
            self.equations,
            self.operators,
            self.fields,
            maximum_local_system_size=maximum_block_size,
            depth=levels,
            FAS=bool(self._program_generator.uses_FAS()),
        )
        self._program_generator.initialize_code_generation(self.min_level, self.max_level)
        tree = gp.parse_tree(grammar_string, pset)
        expression, _ = gp.compile_tree(tree, pset)
        return self._program_generator.generate_and_evaluate(
            expression, infinity=self.infinity, evaluation_samples=evaluation_samples
        )

    @staticmethod
    def visualize_tree(individual, filename):
        from evostencils_torch.utils.visualization import draw_tree

        draw_tree(individual, filename)

    @staticmethod
    def dump_data_structure(data_structure, file_name):
        with open(file_name, "wb") as f:
            pickle.dump(data_structure, f)

    @staticmethod
    def load_data_structure(file_name):
        with open(file_name, "rb") as f:
            return pickle.load(f)
