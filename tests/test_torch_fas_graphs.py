"""FAS on CUDA graphs, on the CPU: the port's FAS stage is a lowered
structure's stage loop (backend/evaluation.StageLoop around a
graphs.StepCycle), captured per structure on a card, as the reference
compiles its FAS stage per structure.

Individuals: the stored FAS champion (artifacts/fas_champion_r5.txt), the
textbook V(2,2)s with Newton and Picard smoothing
(artifacts/fas_textbook_V22_jacobi_{newton,picard}.txt), all three on
fas_2d at levels 2-6 (63²: the depth-4 trees need five levels), and the
FAS template's two-grid V(2,2) (ω = 0.8) on the parsed
FAS_2D_Basic_template.exa4 at levels 4-5.

* nothing inside one FAS cycle (the Newton and Picard point solves, the
  200 damped Picard sweeps of the coarsest solve) or the stage's `start`
  and `post` bodies reads a value to the host or makes a tensor from host
  data, after a warm-up call (the guard of tests/torch_parity.py);
* a generator whose graphs replay the bodies eagerly
  (`torch_parity.eager_capture`) scores each individual in float32 as the
  `cuda_graphs=False` generator does, ρ, iterations and every stage's
  executed count to the bit, with one cached loop per FAS structure that
  a second evaluation reuses;
* and in float64 as the JAX package does, within tests/test_torch_fas.py's
  bands: one captured cycle within 1e-10 relative to max|u|, and the
  champion's and the template's ρ within 1e-6 relative with equal
  iterations (the textbooks' stage stalls, and its ρ follows the
  rounding).
"""

import os

import jax.numpy as jnp
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.ir import reference_cycles as jax_reference_cycles
from evostencils_tpu.problems import fas as jax_fas
from evostencils_tpu.problems import load_problem_file as jax_load_problem_file
from evostencils_torch.backend import graphs
from evostencils_torch.backend.evaluation import StageLoop, TorchProgramGenerator
from evostencils_torch.ir import reference_cycles
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.problems import fas, load_problem_file
from torch_parity import (  # noqa: F401 (eager_graphs: a fixture)
    INFINITY, JAX, JAX_DTYPES, PORT, Side, assert_close_relative, eager_graphs, jax_state,
    no_host_reads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts")
FILES = {
    "champion": os.path.join(ARTIFACTS, "fas_champion_r5.txt"),
    "newton": os.path.join(ARTIFACTS, "fas_textbook_V22_jacobi_newton.txt"),
    "picard": os.path.join(ARTIFACTS, "fas_textbook_V22_jacobi_picard.txt"),
}
TEMPLATE = os.path.join(ARTIFACTS, "problem_specs", "FAS_2D_Basic_template.exa4")
NAMES = ("champion", "newton", "picard", "template")


def _tree_string(path):
    with open(path) as f:
        return "".join(line for line in f if not line.startswith("#")).strip()


def _individual(name, package, dtype):
    """(problem, expression) of individual `name` built by `package`."""
    jax = package is JAX
    if name == "template":
        load = jax_load_problem_file if jax else load_problem_file
        problem = load(TEMPLATE, dtype=JAX_DTYPES[dtype] if jax else dtype).with_levels(4, 5)
        side = Side(package, problem, maximum_local_system_size=4)
        cycles = jax_reference_cycles if jax else reference_cycles
        return problem, cycles.generate_fas_v_22_cycle_two_grid(
            side.terminals[0], problem.rhs(), omega=0.8)
    build = jax_fas.fas_2d if jax else fas.fas_2d
    problem = build(2, 6, dtype=JAX_DTYPES[dtype] if jax else dtype)
    side = Side(package, problem, depth=4, maximum_local_system_size=4)
    return problem, side.compile(_tree_string(FILES[name]))


@pytest.mark.parametrize("name", NAMES)
def test_no_host_read_inside_a_fas_cycle_and_the_stage_bodies(name):
    problem, expression = _individual(name, PORT, torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    assert generator._vm_program(expression) == (None, None)
    (_, _, operator), omegas = generator._build_solver(expression)
    u0, f, _, _ = generator._probe_state(expression)
    step = generator.lowering.lower_parameterized(expression)[0]

    def residual_norm(u, rhs):
        return sops.l2_norm(sops.tree_sub(rhs, generator.lowering.system_apply(operator, u)))

    loop = StageLoop(graphs.StepCycle(step, omegas, u0), residual_norm)
    loop.load(u0, f, omegas)
    for _ in range(2):
        loop.run("start")
        loop.step()
    with no_host_reads():
        loop.run("start")
        loop.step()
    assert int(loop.it) == 1 and float(loop.res) < float(loop.best_res) * 1e3


@pytest.mark.parametrize("name", NAMES)
def test_a_generator_on_eager_graphs_scores_fas_as_the_eager_one(name, eager_graphs):
    problem, expression = _individual(name, PORT, torch.float32)
    cached = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    cached.graph_cache = graphs.GraphCache()
    eager = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu", cuda_graphs=False)
    got = cached.generate_and_evaluate(expression, evaluation_samples=1)
    expected = eager.generate_and_evaluate(expression, evaluation_samples=1)
    assert got[1:] == expected[1:] and got[0] < INFINITY, (got, expected)
    assert cached.last_cycle_solve == eager.last_cycle_solve
    assert len(cached.last_cycle_solve["stage_executed"]) == 1  # one stage, no power loop
    # One loop per FAS structure: the stage's, with its cycle, captured once.
    (key,) = cached.graph_cache._entries
    assert key == cached._structural_key(expression) + ("stage",)
    assert cached.graph_cache.captures["solve"] == 3  # start, post and the cycle
    before = graphs.counters.captures
    assert cached.generate_and_evaluate(expression, evaluation_samples=1)[1:] == got[1:]
    assert graphs.counters.captures == before and len(cached.graph_cache) == 1


@pytest.mark.parametrize("name", NAMES)
def test_fas_on_eager_graphs_matches_the_reference(name, eager_graphs):
    """One captured cycle from the initial state within 1e-10 of the JAX
    package's (relative to max|u|, tests/test_torch_fas.py's cycle band);
    the champion's and the template's fitness within the float64 band.  The
    textbooks' fitness is not compared: their stage stalls after a few
    cycles, and the stall rule's ρ follows the rounding (ROADMAP Queue 3;
    at 63² the JAX package gives 0.827 in 122 and 0.789 in 97, the port
    0.729 in 73 and 0.729 in 73, Newton and Picard)."""
    jax_problem, jax_expression = _individual(name, JAX, torch.float64)
    problem, expression = _individual(name, PORT, torch.float64)
    port = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    port.graph_cache = graphs.GraphCache()
    u0, f = problem.initial_state(torch.float64, device="cpu")
    cycle = graphs.StepCycle(port.lowering.lower_parameterized(expression)[0],
                             port._omega_vector(expression), u0)
    cycle.load(port._omega_vector(expression))
    cycle.capture_bodies()
    for d, x in ((cycle.u, u0), (cycle.f, f)):
        for a, b in zip(d, x):
            a.copy_(b)
    cycle.run_cycle()
    ju, jf = jax_problem.initial_state(jnp.float64)
    # Both sides take ω as float32, as their generators do.
    jax_step, omegas = JaxLowering(jnp.float64, use_pallas=False).lower_parameterized(
        jax_expression)
    expected = jax_step(jax_state(ju, jnp.float64), jax_state(jf, jnp.float64),
                        jnp.asarray(omegas, dtype=jnp.float32))
    assert_close_relative(cycle.u, expected, 1e-10)
    if name in ("newton", "picard"):
        return
    reference = JaxProgramGenerator(jax_problem, dtype=jnp.float64)
    t_ref, rho_ref, it_ref = reference.generate_and_evaluate(jax_expression,
                                                             evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(expression, evaluation_samples=1)
    assert len(port.graph_cache) == 1
    assert (t < INFINITY) == (t_ref < INFINITY) and rho < 1.0
    assert abs(rho - rho_ref) <= 1e-6 * rho_ref and it == it_ref, (rho, rho_ref, it, it_ref)
