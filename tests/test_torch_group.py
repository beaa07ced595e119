"""Same-structure group evaluation (`generate_and_evaluate_group`) on the CPU.

The members are the stored champion (`artifacts/poisson2d_champion_r2_tuned.txt`,
a depth-4 tree, so levels 2-6, 63² finest) with different ω vectors, in
float32, where both packages measure ρ by the power iteration.

* On the port, the group gives every member exactly the ρ and iterations
  of `generate_and_evaluate`, and one time per iteration, measured once.
* Against the JAX package's group path (its cycle VM, vmapped over ω): ρ
  within 2 % and iterations within ±1, the champion check's tolerance.
  These members are V(2,1) textbook cycles at levels 3-5 with four ω: the
  JAX package compiles its VM interpreter three times for a group (power,
  vmapped power, stage), which takes about 30 s here at three levels and
  over 70 s at the champion's five.
* Members that the power iteration alone decides: a non-finite rate (∞),
  ρ ≥ 1 (the iteration cap) and more iterations than the cap.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar import gp as jax_gp
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp, multigrid
from evostencils_torch.ir.transformations import canonical_string, collect_cycles
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import parse_champion_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")
INFINITY = 1e100
MIN_LEVEL, MAX_LEVEL = 2, 6


def _omega_vectors(stored, n):
    """The stored ω and n - 1 seeded perturbations of it inside the
    grammar's interval [0.1, 1.9]."""
    rng = np.random.default_rng(13)
    vectors = [list(stored)]
    for _ in range(n - 1):
        vectors.append(list(np.clip(np.asarray(stored) * rng.uniform(0.85, 1.1, len(stored)),
                                    0.1, 1.9)))
    return vectors


def _members(problem, gp_module, grammar, cycles_of, omega_vectors):
    tree_string, _ = parse_champion_file(CHAMPION)
    pset, _ = grammar.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=problem.max_level - problem.min_level,
        maximum_local_system_size=8)
    members = []
    for omegas in omega_vectors:
        expression = gp_module.compile_tree(gp_module.parse_tree(tree_string, pset), pset)[0]
        cycles = cycles_of(expression)
        assert len(cycles) == len(omegas)
        for cycle, omega in zip(cycles, omegas):
            cycle.relaxation_factor = float(omega)
        members.append(expression)
    return members


def _port_members(omega_vectors):
    problem = poisson_2d(MIN_LEVEL, MAX_LEVEL, dtype=torch.float32)
    return problem, _members(problem, gp, multigrid, collect_cycles, omega_vectors)


@pytest.fixture(scope="module")
def stored_omegas():
    return parse_champion_file(CHAMPION)[1]


def _count_timings(generator):
    calls = []
    timed = generator._time_per_iteration_ms

    def counting(*args):
        calls.append(args)
        return timed(*args)

    generator._time_per_iteration_ms = counting
    return calls


def test_group_matches_single_evaluation_exactly(stored_omegas):
    vectors = _omega_vectors(stored_omegas, 5)
    problem, members = _port_members(vectors)
    keys = {canonical_string(e, parameterize_relaxation=True) for e in members}
    assert len(keys) == 1 and len({canonical_string(e) for e in members}) == 5

    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    timings = _count_timings(generator)
    group = generator.generate_and_evaluate_group(members, infinity=INFINITY,
                                                  evaluation_samples=1)
    assert len(timings) == 1
    singles = [generator.generate_and_evaluate(e, infinity=INFINITY, evaluation_samples=1)
               for e in members]
    assert [(rho, it) for _, rho, it in group] == [(rho, it) for _, rho, it in singles]
    assert all(rho < 1.0 for _, rho, _ in group)
    per_iteration = {round(t / it, 9) for t, _, it in group}
    assert len(per_iteration) == 1 and all(math.isfinite(t) for t, _, _ in group)
    assert generator.vm_stats()["vm_misses"] == 0


def _textbook_members(problem, gp_module, grammar):
    pset, terminals = grammar.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=2, maximum_local_system_size=8)
    return [
        gp_module.compile_tree(gp_module.parse_tree(
            grammar.textbook_cycle_string(terminals, 2, 1, omega_index=i), pset), pset)[0]
        for i in (12, 14, 16, 18)
    ]


def test_group_matches_reference_group():
    problem = poisson_2d(3, 5, dtype=torch.float32)
    port = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    got = port.generate_and_evaluate_group(
        _textbook_members(problem, gp, multigrid), infinity=INFINITY, evaluation_samples=1)

    jax_problem = jax_poisson_2d(3, 5, dtype=jnp.float32)
    reference = JaxProgramGenerator(jax_problem, dtype=jnp.float32)
    expected = reference.generate_and_evaluate_group(
        _textbook_members(jax_problem, jax_gp, jax_multigrid),
        infinity=INFINITY, evaluation_samples=1)
    assert reference.vm_hits == port.vm_hits == 1
    assert all(rho_ref < 1.0 for _, rho_ref, _ in expected)
    for (_, rho, it), (_, rho_ref, it_ref) in zip(got, expected):
        assert abs(rho - rho_ref) <= 0.02 * rho_ref, (rho, rho_ref)
        assert abs(it - it_ref) <= 1, (it, it_ref)
    print("group vs reference: largest relative ρ difference",
          max(abs(g[1] - e[1]) / e[1] for g, e in zip(got, expected)),
          "largest iteration difference", max(abs(g[2] - e[2]) for g, e in zip(got, expected)))


def test_group_members_decided_by_the_power_iteration(stored_omegas):
    vectors = _omega_vectors(stored_omegas, 4)
    # The last cycle's ω at 1e15 overflows the error norm: rate +∞.
    vectors[1] = list(stored_omegas[:-1]) + [1e15]
    vectors[2] = [1.9] * len(stored_omegas)    # diverges: ρ ≥ 1
    problem, members = _port_members(vectors)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    timings = _count_timings(generator)
    group = generator.generate_and_evaluate_group(members, infinity=INFINITY,
                                                  evaluation_samples=1)
    assert group[1] == (INFINITY, INFINITY, INFINITY)
    assert group[2][0] == INFINITY and group[2][1] >= 1.0
    assert group[2][2] == generator.iteration_limit
    assert group[0][0] < INFINITY and group[3][0] < INFINITY
    assert len(timings) == 1

    # Over the cap: ρ < 1 but more iterations than the limit allows.
    capped = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=5, device="cpu")
    timings = _count_timings(capped)
    for t, rho, it in capped.generate_and_evaluate_group(
            [members[0], members[3]], infinity=INFINITY, evaluation_samples=1):
        assert t == INFINITY and rho < 1.0 and it > 5
    assert not timings


def test_group_falls_back_one_by_one_in_float64(stored_omegas):
    problem = poisson_2d(MIN_LEVEL, MAX_LEVEL, dtype=torch.float64)
    members = _members(problem, gp, multigrid, collect_cycles, _omega_vectors(stored_omegas, 2))
    generator = TorchProgramGenerator(problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    group = generator.generate_and_evaluate_group(members, infinity=INFINITY,
                                                  evaluation_samples=1)
    singles = [generator.generate_and_evaluate(e, infinity=INFINITY, evaluation_samples=1)
               for e in members]
    assert [(rho, it) for _, rho, it in group] == [(rho, it) for _, rho, it in singles]
    assert generator.evaluate_objectives(members[0], evaluation_samples=1)[0] == group[0][1]
