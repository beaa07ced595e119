"""The plain reference against the port on the CPU at small sizes: pool
trees and the tuned champion of 2D Poisson at 63² (levels 2-6, the cells'
depth-4 grammar), one Helmholtz textbook preconditioner at 31² (levels 1-5,
k = 20, so h·k stays 0.625), and the staged solve's verdict."""

import math
import os

import numpy as np
import pytest
import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas
from portbench.kinds import common, outer, search
from portbench.reference import hierarchy
from portbench.reference.cycle import Cycle, compile_tree, parse
from portbench.reference.residual import relative_residual

DATA = os.path.join(common.HERE, "data")
SMALL = {"name": "poisson2d_511", "min_level": 2, "max_level": 6, "dtype": "float32",
         "grammar_depth": 4, "maximum_local_system_size": 8, "iteration_limit": 500,
         "residual_target": 1e-12, "power_error_seed": 7}


def _port(config, text, omegas=None):
    problem = poisson_2d(config["min_level"], config["max_level"], dtype=torch.float32)
    pset, _ = common.primitive_set(problem, config)
    expr = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
    if omegas is not None:
        assert apply_stored_omegas(expr, omegas)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=500,
                                      device="cpu")
    return generator.generate_and_evaluate(expr, evaluation_samples=1)


@pytest.mark.parametrize("index", [0, 3, 9, 12, 15])
def test_pool_trees_match_the_port(index):
    text = common.read_pool(os.path.join(DATA, "poisson2d_511_trees.txt"))[index]
    t, rho, it = _port(SMALL, text)
    reference = search.reference_fitness(text, SMALL, "cpu")
    rho_gap, iteration_gap = search.gaps({"t": t, "rho": rho, "it": it}, reference)
    assert rho_gap < 1e-5 and iteration_gap == 0.0, (reference, (t, rho, it))


def test_the_tuned_champion_matches_the_port():
    text, omegas = common.read_champion(os.path.join(DATA, "poisson2d_champion_r2_tuned.txt"))
    assert Cycle(text, 6, omegas=omegas).omegas_applied
    t, rho, it = _port(SMALL, text, omegas)
    n = 2 ** 6 - 1
    e0 = torch.from_numpy(search.seeded_error((n, n))).double()
    from portbench.reference.fitness import power_rate, power_verdict

    rate, _ = power_rate(Cycle(text, 6, omegas=omegas), e0)
    cls, ref_rho, ref_it = power_verdict(rate, 1e-12, 500)
    assert cls == "converged" and rho < 0.2
    assert abs(rho - ref_rho) < 1e-5 * ref_rho and it == ref_it


def test_a_helmholtz_textbook_matches_the_port():
    config = {"min_level": 1, "max_level": 5, "k": 20.0, "shift": [1.0, 0.5],
              "boundary": "dirichlet", "dtype": "complex128", "outer_target": 1e-7,
              "outer_cap": 10000, "probe_iterations": 128, "grammar_depth": 4,
              "maximum_local_system_size": 8}
    path = os.path.join(DATA, "helmholtz_textbook_V2_1_w0.6.txt")
    problem = outer.build_problem(config)
    pset, _ = common.primitive_set(problem, config)
    text, _ = common.read_champion(path)
    expr = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
    generator = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu",
                                      ladder_rungs=1)
    t, rho, it = generator.generate_and_evaluate(expr, evaluation_samples=1,
                                                 global_variable_values={"k": 20.0})
    reference = outer.reference_fitness(path, config, "cpu")
    assert reference[0] == "converged" and math.isfinite(t)
    iteration_gap, rho_gap = outer.gaps({"t": t, "rho": rho, "it": it}, reference)
    # BiCGStab carries rounding from the first iterations on: counts of one
    # solve in two summation orders differ by a few iterations.
    assert iteration_gap <= 0.1 and rho_gap <= 0.05, (reference, (t, rho, it))


def test_the_verdict_residual_is_the_operators():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((31, 31))
    level = hierarchy.Level(5)
    f = level.apply(torch.from_numpy(u)).numpy()
    assert relative_residual(u, f, 5) < 1e-14
    assert relative_residual(np.zeros_like(u), f, 5) == pytest.approx(1.0)


def test_intergrid_transfers_are_full_weighting_and_bilinear():
    coarse = torch.arange(9, dtype=torch.float64).reshape(3, 3)
    fine = hierarchy.prolong(coarse)
    assert fine.shape == (7, 7)
    assert torch.equal(fine[1::2, 1::2], coarse)
    assert fine[2, 1] == pytest.approx(0.5 * (coarse[0, 0] + coarse[1, 0]))
    assert fine[0, 0] == pytest.approx(0.25 * coarse[0, 0])
    # Full weighting is the transpose of bilinear interpolation over 4.
    x = torch.randn(7, 7, dtype=torch.float64)
    y = torch.randn(3, 3, dtype=torch.float64)
    assert torch.sum(hierarchy.restrict(x) * y) == pytest.approx(
        0.25 * torch.sum(x * hierarchy.prolong(y)))


def test_the_parser_numbers_the_relaxation_slots_in_completion_order():
    text = ("collective_jacobi_0(rf_2,red_black,residual_0(update_with_coarse_grid_correction_0("
            "rf_18,P_1,collective_jacobi_1__2(rf_4,single,coarsening_0(A_1,zero_1,R_0,"
            "residual_0(collective_block_jacobi_0(rf_6,bs_2x1,residual_0(u_and_f))))))))")
    program = compile_tree(parse(text))
    assert [(i.op, i.omega_index) for i in program] == [
        ("start", None), ("block_jacobi", "rf_6"), ("coarsen", None), ("jacobi", "rf_4"),
        ("correct", "rf_18"), ("jacobi", "rf_2")]
    cycle = Cycle(text, 4, omegas=[0.5, 0.6, 0.7, 0.8])
    plain = Cycle(text, 4)
    assert [i.omega for i in plain.program if i.omega_index] == pytest.approx([0.4, 0.3, 1.0, 0.2])
    assert [i.omega for i in cycle.program if i.omega_index] == [0.5, 0.6, 0.7, 0.8]
    assert not Cycle(text, 4, omegas=[0.5]).omegas_applied
