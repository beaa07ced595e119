"""The problem-file slice as a whole, on the CPU: the same spec files
parsed by each package and evaluated by JaxProgramGenerator and
TorchProgramGenerator(device="cpu").

* 2D Poisson (2D_FD_Poisson_fromL2.exa2), the exafile champion of
  RESULTS.md R5.5 untuned and with its stored ω, float64, residual target
  1e-6: ρ within 1e-8 and equal iterations, the band of the float64 parity
  test in tests/test_torch_slice.py.  The champion was evolved for five
  levels (a depth-4 grammar), so the spec is cut to levels 2-6 (63²) and not
  to 3-5; on the port the parsed problem and poisson_2d score it alike, to
  the digit.
* 2D Helmholtz (2D_FD_Helmholtz_fromL3.exa3) at k = 20, levels 3-5,
  complex128, the textbook V(2,1) ω = 0.6 preconditioning BiCGStab: outer
  iterations within ±2 and ρ within 10 %, the bands of
  tests/test_torch_helmholtz.py (CPU anchor of helmholtz_2d: 21).
* FAS (FAS_2D_Basic_template.exa4) at levels 4-5: the two-grid FAS V(2,2)
  ω = 0.8 in float64, ρ within 1e-6 and equal iterations, the band of
  tests/test_torch_fas.py.
* scripts/torch_optimize.py --problem-file on the CPU for one generation.
"""

import os

import jax.numpy as jnp
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.ir import reference_cycles as jax_cycles
from evostencils_tpu.problems import load_problem_file as jax_load_problem_file
from evostencils_tpu.utils import champions as jax_champions
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ir import reference_cycles
from evostencils_torch.problems import helmholtz, load_problem_file, poisson
from evostencils_torch.utils import champions
from scripts import torch_optimize
from torch_parity import JAX, PORT, Side

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "artifacts", "problem_specs")
POISSON = os.path.join(SPECS, "2D_FD_Poisson_fromL2.exa2")
HELMHOLTZ = os.path.join(SPECS, "2D_FD_Helmholtz_fromL3.exa3")
FAS = os.path.join(SPECS, "FAS_2D_Basic_template.exa4")
CHAMPIONS = {
    "untuned": os.path.join(ROOT, "artifacts", "exafile_poisson_champion_r5.txt"),
    "tuned": os.path.join(ROOT, "artifacts", "exafile_poisson_champion_r5_tuned.txt"),
}
COUNT_BAND = 2
RHO_BAND = 0.10


def _champion(side, path):
    """The stored champion through the side's own grammar, with its stored ω
    applied by the side's own champions module."""
    module = jax_champions if side.package is JAX else champions
    tree_string, omegas = module.parse_champion_file(path)
    expression = side.compile(tree_string)
    if omegas is not None:
        assert module.apply_stored_omegas(expression, omegas, label=path)
    return expression


@pytest.mark.parametrize("label", sorted(CHAMPIONS))
def test_exafile_champion_on_the_parsed_poisson_matches_reference(label):
    jax_side = Side(JAX, jax_load_problem_file(POISSON, dtype=jnp.float64).with_levels(2, 6))
    port_side = Side(PORT, load_problem_file(POISSON, dtype=torch.float64).with_levels(2, 6))
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, epsilon=1e-6)
    port = TorchProgramGenerator(port_side.problem, dtype=torch.float64, epsilon=1e-6,
                                 device="cpu")
    _, rho_ref, it_ref = reference.generate_and_evaluate(
        _champion(jax_side, CHAMPIONS[label]), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(
        _champion(port_side, CHAMPIONS[label]), evaluation_samples=1)
    assert abs(rho - rho_ref) <= 1e-8 * rho_ref and it == it_ref, (rho, rho_ref, it, it_ref)
    assert t < 1e50 and 0 < rho < 0.2
    # The hand-written problem scores it alike on the port, to the digit.
    hand_side = Side(PORT, poisson.poisson_2d(2, 6, dtype=torch.float64))
    hand = TorchProgramGenerator(hand_side.problem, dtype=torch.float64, epsilon=1e-6,
                                 device="cpu")
    _, rho_hand, it_hand = hand.generate_and_evaluate(
        _champion(hand_side, CHAMPIONS[label]), evaluation_samples=1)
    assert (rho_hand, it_hand) == (rho, it)


def _v21(cycles, side):
    """The textbook V(2,1) ω = 0.6 of tests/test_torch_helmholtz.py."""
    return cycles.generate_v_cycle(side.terminals, side.problem.rhs(), pre_smoothing=2,
                                   post_smoothing=1, omega=0.6)


def test_parsed_helmholtz_matches_reference_within_the_bands():
    def problem(load, dtype):
        return load(HELMHOLTZ, dtype=dtype).with_levels(3, 5).with_parameters({"k": 20.0})

    jax_side = Side(JAX, problem(jax_load_problem_file, jnp.complex128))
    port_side = Side(PORT, problem(load_problem_file, torch.complex128))
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.complex128)
    port = TorchProgramGenerator(port_side.problem, dtype=torch.complex128, device="cpu")
    _, rho_ref, it_ref = reference.generate_and_evaluate(
        _v21(jax_cycles, jax_side), evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(_v21(reference_cycles, port_side),
                                            evaluation_samples=1)
    assert t < 1e50 and rho < 1.0
    assert abs(it - it_ref) <= COUNT_BAND, (it, it_ref)
    assert abs(rho - rho_ref) <= RHO_BAND * rho_ref, (rho, rho_ref)
    # The hand-written helmholtz_2d on the port: its CPU anchor is 21.
    hand_side = Side(PORT, helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=torch.complex128))
    hand = TorchProgramGenerator(hand_side.problem, dtype=torch.complex128, device="cpu")
    _, _, it_hand = hand.generate_and_evaluate(_v21(reference_cycles, hand_side),
                                               evaluation_samples=1)
    assert abs(it_hand - 21) <= COUNT_BAND and abs(it - it_hand) <= COUNT_BAND, (it, it_hand)


def test_parsed_fas_template_matches_reference():
    jax_side = Side(JAX, jax_load_problem_file(FAS, dtype=jnp.float64).with_levels(4, 5),
                    maximum_local_system_size=4)
    port_side = Side(PORT, load_problem_file(FAS, dtype=torch.float64).with_levels(4, 5),
                     maximum_local_system_size=4)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, iteration_limit=100)
    port = TorchProgramGenerator(port_side.problem, dtype=torch.float64, iteration_limit=100,
                                 device="cpu")
    _, rho_ref, it_ref = reference.generate_and_evaluate(
        jax_cycles.generate_fas_v_22_cycle_two_grid(
            jax_side.terminals[0], jax_side.problem.rhs(), omega=0.8),
        evaluation_samples=1)
    t, rho, it = port.generate_and_evaluate(
        reference_cycles.generate_fas_v_22_cycle_two_grid(
            port_side.terminals[0], port_side.problem.rhs(), omega=0.8),
        evaluation_samples=1)
    assert abs(rho - rho_ref) <= 1e-6 * rho_ref and it == it_ref, (rho, rho_ref, it, it_ref)
    assert t < 1e50 and rho < 0.5 and it < 100


def test_evolution_from_a_problem_file(tmp_path):
    output = tmp_path / "evolve"
    result = torch_optimize.run([
        "--cpu", "--problem-file", POISSON, "--min-level", "3", "--max-level", "5",
        "--method", "nsga2", "--mu", "4", "--lambda", "4", "--generations", "1",
        "--evaluation-samples", "1", "--seed", "20260819", "--output", str(output),
    ])
    problem = result.generator.problem
    assert (problem.name, problem.min_level, problem.max_level) == ("2D_FD_Poisson_fromL2", 3, 5)
    assert (output / "individual_0.txt").is_file() and (output / "program.txt").is_file()
    rhos = [ind.fitness_values[0] for hof in result.halls_of_fame for ind in hof]
    assert any(0 < rho < 1 for rho in rhos), rhos
    # The levels come from the spec's knowledge file unless overridden.
    args = torch_optimize.parse_arguments(["--cpu", "--problem-file", POISSON])
    problem = torch_optimize._build_problem(args)
    assert (problem.min_level, problem.max_level, problem.dtype) == (5, 9, torch.float32)
    args = torch_optimize.parse_arguments(
        ["--cpu", "--problem-file", HELMHOLTZ, "--knowledge",
         os.path.join(SPECS, "2D_FD_Poisson_fromL2.knowledge"), "--dtype", "complex128"])
    problem = torch_optimize._build_problem(args)
    assert (problem.min_level, problem.max_level, problem.dtype) == (5, 9, torch.complex128)
    assert problem.outer_solver["max_iterations"] == 10000
