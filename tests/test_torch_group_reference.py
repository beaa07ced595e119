"""The group path against the benchmark's plain reference, on the CPU.

Three groups of the groups cell's traffic (`portbench/data/
poisson2d_511_groups.txt`, drawn by `portbench/data/make_groups.py`'s rule:
each later member's ω terminals redrawn with probability 1/4) at levels 2-6
(63² finest) instead of 5-9, each scored by one `generate_and_evaluate_group`
call:

* g10, 16 members (bucket 16) through the cycle VM, every member converging;
* g1, 8 members through the IR lowering (every tree of the pool translates
  into the VM, so this generator has its VM turned off, as
  tests/test_torch_group_batched.py's lowered groups do);
* g3, 8 members through the VM, one of which diverges (ρ ≈ 1.2) among
  members that converge.

Each member's class, ρ and iterations are held to the cell's own limits
(`portbench/limits/poisson2d_511.groups.json`) of `portbench.reference`'s
float64 fitness of the member's tree string, by the cell's check
(`portbench.kinds.search.gaps`): the class must agree, ρ within 4e-3
relative, iterations within 1 %.  Why those tolerances: the port runs the
power iteration in float32 where the reference runs float64, so ρ differs by
float32 rounding of the normalised error, 3e-7 relative here and 1.3e-5 at
511² (`PERF.md` §2); the iteration count ⌈log ε / log ρ⌉ moves only where ρ
lies within that rounding of a step, which no member here does.  A
bfloat16 reference put in the port's place misses at least one of the
limits (ρ gaps of 1-3 %), so the limits tell the configured precision from
the next one below it.
"""

import json
import os
import random

import pytest
import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.problems.poisson import poisson_2d
from portbench.kinds import common, groups, search
from portbench.reference.fitness import cycle_class

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFINITY = 1e100
CPU = torch.device("cpu")


def _load(name):
    with open(os.path.join(ROOT, "portbench", name)) as fh:
        return json.load(fh)


CONFIG = {**_load("configs/poisson2d_511_groups.json"), "min_level": 2, "max_level": 6}
LIMITS = _load("limits/poisson2d_511.groups.json")
TEXTS, GROUPS = groups.read_groups(os.path.join(ROOT, "portbench", "data",
                                                "poisson2d_511_groups.txt"))


def _scored(g, lowered=False):
    """[(member id, (t, ρ, iterations))] of group g by one group call."""
    problem = poisson_2d(CONFIG["min_level"], CONFIG["max_level"], dtype=torch.float32)
    pset, _ = common.primitive_set(problem, CONFIG)
    generator = TorchProgramGenerator(problem, dtype=torch.float32,
                                      iteration_limit=CONFIG["iteration_limit"], device="cpu")
    if lowered:
        generator._vm_program = lambda expression: (None, None)
    exprs = [gp.compile_tree(gp.parse_tree(TEXTS[m], pset), pset)[0] for m in GROUPS[g]]
    results = generator.generate_and_evaluate_group(exprs, infinity=INFINITY,
                                                    evaluation_samples=1)
    assert generator.groups_batched == 1 and generator.batched_members == len(exprs)
    assert (generator.vm_hits > 0) != lowered
    return list(zip(GROUPS[g], results))


def _gaps(scored, dtype=torch.float64):
    """Worst (ρ gap, iteration gap) of the members against the float64
    reference; with `dtype` the reference in that dtype takes the port's
    place."""
    worst = [0.0, 0.0]
    for member, (t, rho, it) in scored:
        reference = search.reference_fitness(TEXTS[member], CONFIG, CPU)
        if dtype != torch.float64:
            c, rho, it = search.reference_fitness(TEXTS[member], CONFIG, CPU, dtype)
            t = 1.0 if c == "converged" else INFINITY
        record = {"t": t, "rho": rho, "it": it}
        worst = [max(w, gap) for w, gap in zip(worst, search.gaps(record, reference))]
    return worst


@pytest.mark.parametrize("g, size, lowered", [(10, 16, False), (1, 8, True), (3, 8, False)],
                         ids=["vm-16", "lowered-8", "vm-8-diverging"])
def test_group_members_lie_within_the_cells_limits_of_the_reference(g, size, lowered):
    scored = _scored(g, lowered)
    assert len(scored) == size
    classes = [cycle_class(t, rho) for _, (t, rho, _) in scored]
    if g == 3:
        assert "diverged" in classes and "converged" in classes
    else:
        assert set(classes) == {"converged"}
    rho_gap, iteration_gap = _gaps(scored)
    assert rho_gap <= LIMITS["rho_gap"] and iteration_gap <= LIMITS["iteration_gap"], (
        rho_gap, iteration_gap)


def test_a_bfloat16_reference_in_the_ports_place_misses_the_limits():
    rho_gap, iteration_gap = _gaps(_scored(3), dtype=torch.bfloat16)
    assert rho_gap > LIMITS["rho_gap"] or iteration_gap > LIMITS["iteration_gap"]


def test_the_optimizer_sends_a_group_of_the_cell_through_the_group_path(tmp_path):
    """`Optimizer._evaluate_population`, as a measured search's generation
    runs it, scores g3's 8 members by one batched group call."""
    problem = poisson_2d(CONFIG["min_level"], CONFIG["max_level"], dtype=torch.float32)
    pset, _ = common.primitive_set(problem, CONFIG)
    generator = TorchProgramGenerator(problem, dtype=torch.float32,
                                      iteration_limit=CONFIG["iteration_limit"], device="cpu")
    optimizer = Optimizer.for_problem(problem, program_generator=generator,
                                      checkpoint_directory_path=str(tmp_path),
                                      rng=random.Random(1))
    optimizer._pset, optimizer._measured_evaluation, optimizer._n_objectives = pset, True, 1
    individuals = [gp.parse_tree(TEXTS[m], pset) for m in GROUPS[3]]
    evaluated = optimizer._evaluate_population(
        individuals, optimizer.evaluate_single_objective, evaluation_samples=1)
    assert evaluated == len(individuals) == 8
    assert generator.groups_batched == 1 and generator.batched_members == 8
    assert all(ind.fitness_values is not None for ind in individuals)
