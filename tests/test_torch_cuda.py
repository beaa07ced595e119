"""The CUDA kernel against its plain torch version, and the Krylov solvers,
a Helmholtz evaluation and one cycle of each problem family without a
kernel (variable coefficients, FAS, 3D, elasticity) on the card against the
same on the CPU.

These tests need an NVIDIA GPU (sm_90a) and skip without one.  The file
imports nothing of JAX, so it runs on the machine with the card, where
JAX is not installed (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m "cuda and not slow" tests/test_torch_cuda.py -q

One test is also marked slow (two solves of thousands of outer iterations,
about 35 s each on an H100): run it with -m "cuda and slow" -s.
"""

import os
import random

import numpy as np
import pytest
import torch

from evostencils_torch import CudaGraphError
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir import base, reference_cycles, smoother
from evostencils_torch.ir import partitioning as part
from evostencils_torch.ops import krylov, rb_sweep
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.problems.api import make_grid
from evostencils_torch.problems import elasticity, fas, poisson
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant, gallery

ENTRIES = {
    "5-point": (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0)),
    # Same-colour diagonal coupling: catches an update in place within a colour.
    "9-point": (((0, 0), 8.0 / 3), ((1, 0), -1 / 3), ((-1, 0), -1 / 3), ((0, 1), -1 / 3),
                ((0, -1), -1 / 3), ((1, 1), -1 / 3), ((1, -1), -1 / 3), ((-1, 1), -1 / 3),
                ((-1, -1), -1 / 3)),
    # Radius 1, neither the 5-point nor the 9-point pattern: the kernel's
    # generic radius-1 instance.
    "skew": (((0, 0), 2.0), ((1, 1), -0.5), ((-1, 0), -0.25), ((0, -1), -0.25)),
    "radius-2": (((0, 0), 2.5), ((2, -1), -0.5), ((-2, 1), 0.75), ((0, 2), -0.25), ((1, 0), -0.5)),
    # No symmetry, radius 4: a sign or axis error in the offsets shows up here.
    "asymmetric": (((0, 0), 4.0), ((1, 0), -1.5), ((-1, 0), -0.5), ((0, 1), -0.75),
                   ((0, -2), -0.25), ((2, -1), 0.125), ((-4, 3), -0.0625), ((3, 4), 0.1)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRIES))
@pytest.mark.parametrize(
    "shape", [(31, 31), (63, 63), (127, 127), (255, 255), (511, 511), (1023, 1023), (161, 96)])
def test_kernel_matches_plain_version(cuda, name, shape):
    # Every level size of the 511² and 1023² configurations (both block
    # shapes of csrc/rb_sweep.cu: launch_shape) and a ragged grid, with a
    # stencil for every instance of the kernel; max|Δ| < 5e-5, as
    # tests/test_pallas.py holds the Pallas kernels.
    stencil = constant.Stencil(ENTRIES[name])
    rng = np.random.default_rng(3)
    u, f = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
            for _ in range(2))
    before = rb_sweep.launches.total(), rb_sweep.launches[shape]
    out = rb_sweep.red_black_collective_jacobi_sweep(u, f, 1.15, stencil)
    torch.cuda.synchronize()
    assert (rb_sweep.launches.total(), rb_sweep.launches[shape]) == (before[0] + 1, before[1] + 1)
    assert float((out - rb_sweep.rb_sweep_reference(u, f, 1.15, stencil)).abs().max()) < 5e-5


@pytest.mark.cuda
def test_v22_cycle_on_the_card_launches_the_kernel_and_matches_the_cpu(cuda):
    problem = poisson_2d(3, 5, dtype=torch.float32)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=1, maximum_local_system_size=4,
    )
    cycle = reference_cycles.generate_v_22_cycle_two_grid(terminals[0], problem.rhs())
    u0, f = problem.initial_state(torch.float32, device="cpu")
    expected = CycleLowering(torch.float32, "cpu").lower(cycle)(u0, f)[0]
    before = rb_sweep.launches.total()
    got = CycleLowering(torch.float32, cuda).lower(cycle)(
        tuple(x.to(cuda) for x in u0), tuple(x.to(cuda) for x in f))[0]
    torch.cuda.synchronize()
    assert rb_sweep.launches.total() == before + 4  # two pre- and two post-smoothing steps
    scale = float(expected.abs().max())
    assert float((got.cpu() - expected).abs().max()) / scale < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("solver", sorted(krylov.SOLVERS))
def test_krylov_solver_on_the_card_matches_the_cpu(cuda, solver, dtype):
    # 6 iterations on the shifted Helmholtz operator M (k = 20, 31²) for a
    # complex state, on 2D Poisson for a real one: 1e-10 relative.
    grid = make_grid(5, 2)
    generator = gallery.Helmholtz2D(20.0, complex(1.0, 0.5)) if dtype.is_complex else (
        gallery.Poisson2D())
    stencil = generator.generate_stencil(grid)
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.standard_normal(grid.interior_shape)).to(dtype)

    def apply_a(state):
        return tuple(sops.apply_constant_stencil(x, stencil) for x in state)

    expected = krylov.SOLVERS[solver](apply_a, (f,), 6)[0]
    got = krylov.SOLVERS[solver](apply_a, (f.to(cuda),), 6)[0]
    assert got.device.type == "cuda" and got.dtype == dtype
    assert float((got.cpu() - expected).abs().max() / expected.abs().max()) <= 1e-10


@pytest.mark.cuda
def test_preconditioned_bicgstab_on_the_card_matches_the_cpu(cuda):
    # Damped Jacobi on 2D Poisson at 15² to a reduction of 1e-3, the case of
    # tests/test_torch_krylov.py (21 iterations; the port against JAX there:
    # x 4e-11, norm 6e-9): the same count, x and the norm within 1e-7, the
    # card's reductions rounding differently again.
    stencil = gallery.Poisson2D().generate_stencil(make_grid(4, 2))
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.standard_normal((15, 15)) + 1j * rng.standard_normal((15, 15)))

    def apply_a(state):
        return tuple(sops.apply_constant_stencil(x, stencil) for x in state)

    def apply_m(state):
        return tuple((0.8 / stencil.center_value()) * x for x in state)

    x_cpu, it_cpu, res_cpu = krylov.preconditioned_bicgstab(apply_a, apply_m, (f,), 200, 1e-3)
    x, it, res = krylov.preconditioned_bicgstab(apply_a, apply_m, (f.to(cuda),), 200, 1e-3)
    assert it == it_cpu and 5 < it <= 30, (it, it_cpu)
    x_error = float((x[0].cpu() - x_cpu[0]).abs().max() / x_cpu[0].abs().max())
    assert x_error <= 1e-7 and abs(res - res_cpu) <= 1e-7 * res_cpu, (x_error, res, res_cpu)


@pytest.mark.cuda
def test_helmholtz_evaluation_on_the_card_matches_the_cpu(cuda):
    # The textbook V(2,1) ω = 0.6 at k = 20, levels 3-5, complex128: the
    # same probe verdict and stages; the count within ±2 and ρ within 10 %
    # (tests/test_torch_helmholtz.py's bands for runs of about 20 iterations).
    problem = helmholtz_2d(min_level=3, max_level=5, k=20.0, dtype=torch.complex128)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=2, maximum_local_system_size=8,
    )
    cycle = reference_cycles.generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=0.6)
    on_cpu = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
    on_card = TorchProgramGenerator(problem, dtype=torch.complex128, device=cuda)
    t_cpu, rho_cpu, it_cpu = on_cpu.generate_and_evaluate(cycle, evaluation_samples=1)
    before = rb_sweep.launches.total()
    t, rho, it = on_card.generate_and_evaluate(cycle, evaluation_samples=1)
    assert t < 1e50 and t_cpu < 1e50
    assert abs(it - it_cpu) <= 2 and abs(rho - rho_cpu) <= 0.1 * rho_cpu
    assert on_card.last_outer_solve["probe"] == on_cpu.last_outer_solve["probe"] == "survived"
    assert on_card.last_outer_solve["stages"] == on_cpu.last_outer_solve["stages"]
    # A complex state never reaches the float32 kernel.
    assert rb_sweep.launches.total() == before


@pytest.mark.cuda
@pytest.mark.slow
def test_k320_champion_count_follows_the_summation_order_on_the_card(cuda, monkeypatch, capsys):
    # The stored k = 320 champion (levels 3-7, complex128, cap 10,000) with
    # BiCGStab's inner products summed rows first, then with torch.vdot:
    # only the rounding of the reductions changes.  Both must contract; the
    # counts are printed beside tests/test_torch_helmholtz.py's CPU counts.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "artifacts", "helmholtz_k320_r5", "individual_0.txt")) as f:
        champion = "".join(line for line in f if not line.startswith("#")).strip()
    orders = {
        "rows first": lambda x, y: torch.sum(torch.sum(torch.conj(x) * y, dim=1)),
        "vdot": lambda x, y: torch.vdot(x.reshape(-1), y.reshape(-1)),
    }
    counts = {}
    for name, field_dot in orders.items():
        monkeypatch.setattr(
            krylov, "dot", lambda a, b, _dot=field_dot: sum(_dot(x, y) for x, y in zip(a, b)))
        problem = helmholtz_2d(min_level=3, max_level=7, k=320.0, dtype=torch.complex128)
        generator = TorchProgramGenerator(problem, dtype=torch.complex128, device=cuda)
        optimizer = Optimizer.for_problem(
            problem, program_generator=generator, rng=random.Random(0))
        _, rho, counts[name] = optimizer.generate_and_evaluate_program_from_grammar_representation(
            champion, 4, evaluation_samples=1)
        assert 0.0 < rho < 1.0
    with capsys.disabled():
        print(f"\nk=320 champion on the card, outer iterations by summation order: {counts}")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _terminals(problem, fas_grammar=False):
    return generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level, maximum_local_system_size=8,
        FAS=fas_grammar)


def _v_cycle(terminal_list, rhs, factory, partitioning, omega=0.8, index=0):
    """V(2,2) over every level with the smoother `factory`, an exact
    coarsest solve."""
    t = terminal_list[index]
    u = reference_cycles._smooth(t.approximation, rhs, t.operator, omega, partitioning, 2, factory)
    f_c = base.Multiplication(t.restriction, base.Residual(t.operator, u, rhs))
    if index + 1 < len(terminal_list):
        coarse = _v_cycle(terminal_list, f_c, factory, partitioning, omega, index + 1)
    else:
        coarse = base.Multiplication(base.CoarseGridSolver("CGS", t.coarse_operator), f_c)
    u = base.Cycle(u, rhs, base.Multiplication(t.prolongation, coarse), relaxation_factor=1.0)
    return reference_cycles._smooth(u, rhs, t.operator, omega, partitioning, 2, factory)


def _card_matches_cpu(cuda, problem, cycle, dtype, tolerance, seed=0):
    """One cycle on the card and on the CPU from the same random iterate
    and the problem's right-hand side; no kernel launch on the card."""
    _, f = problem.initial_state(dtype, device="cpu")
    rng = np.random.default_rng(seed)
    u0 = tuple(torch.from_numpy(0.1 * rng.standard_normal(tuple(x.shape))).to(dtype) for x in f)
    expected = CycleLowering(dtype, "cpu").lower(cycle)(u0, f)
    before = rb_sweep.launches.total()
    got = CycleLowering(dtype, cuda).lower(cycle)(
        tuple(x.to(cuda) for x in u0), tuple(x.to(cuda) for x in f))
    torch.cuda.synchronize()
    assert rb_sweep.launches.total() == before
    scale = max(float(e.abs().max()) for e in expected)
    for g, e in zip(got, expected):
        assert g.device.type == torch.device(cuda).type
        assert float((g.cpu() - e).abs().max()) / scale < tolerance


@pytest.mark.cuda
def test_variable_coefficient_cycle_on_the_card_matches_the_cpu(cuda):
    # V(2,2) red-black collective Jacobi at 511² (levels 5-9), float32.
    problem = poisson.poisson_2d_variable(5, 9, dtype=torch.float32)
    cycle = _v_cycle(_terminals(problem)[1], problem.rhs(), smoother.generate_collective_jacobi,
                     part.RedBlack)
    _card_matches_cpu(cuda, problem, cycle, torch.float32, 1e-5)


@pytest.mark.cuda
def test_fas_newton_cycle_on_the_card_matches_the_cpu(cuda):
    # The stored textbook FAS V(2,2) with Newton smoothing at 511², float32.
    problem = fas.fas_2d(5, 9, dtype=torch.float32)
    pset, _ = _terminals(problem, fas_grammar=True)
    with open(os.path.join(ROOT, "artifacts", "fas_textbook_V22_jacobi_newton.txt")) as f:
        tree = "".join(line for line in f if not line.startswith("#")).strip()
    cycle = gp.compile_tree(gp.parse_tree(tree, pset), pset)[0]
    _card_matches_cpu(cuda, problem, cycle, torch.float32, 1e-5)


@pytest.mark.cuda
def test_3d_block_smoother_cycle_on_the_card_matches_the_cpu(cuda):
    # V(2,2) with a 2×4×1 block smoother at 63³ (levels 2-6), float32.
    problem = poisson.poisson_3d(2, 6, dtype=torch.float32)
    cycle = _v_cycle(
        _terminals(problem)[1], problem.rhs(),
        lambda A: smoother.generate_collective_block_jacobi(A, ((2, 4, 1),)), part.Single)
    _card_matches_cpu(cuda, problem, cycle, torch.float32, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("factory", [smoother.generate_decoupled_jacobi,
                                     smoother.generate_collective_jacobi])
def test_elasticity_cycle_on_the_card_matches_the_cpu(cuda, factory):
    # V(2,2) red-black at 255² (levels 5-8, two fields), float64.
    problem = elasticity.linear_elasticity_2d(5, 8, dtype=torch.float64)
    cycle = _v_cycle(_terminals(problem)[1], problem.rhs(), factory, part.RedBlack)
    _card_matches_cpu(cuda, problem, cycle, torch.float64, 1e-12)


def _textbook(problem, pre, post):
    return reference_cycles.generate_v_cycle(_terminals(problem)[1], problem.rhs(), pre, post)


@pytest.mark.cuda
def test_per_cycle_time_graph_figure_is_below_the_wall_figure(cuda):
    from evostencils_torch.utils.timing import per_cycle_time, wall_cycle_time

    problem = poisson_2d(5, 9, dtype=torch.float32)
    step = CycleLowering(torch.float32, cuda).lower(_textbook(problem, 2, 1))
    u0, f = problem.initial_state(torch.float32, device=cuda)
    before = rb_sweep.launches.total()
    step(u0, f)
    one_cycle = rb_sweep.launches.total() - before
    replayed_before = rb_sweep.replayed.total()
    device_s = per_cycle_time(step, u0, f, iters=20, repeats=3)
    # The capture's three warm-up calls launch the kernel, the capture
    # itself nothing, and each replay a cycle's launches: one replay first,
    # then 20 and 60 per repeat.
    replays = 1 + 3 * (20 + 60)
    assert one_cycle > 0 and rb_sweep.launches.total() - before == (4 + replays) * one_cycle
    assert rb_sweep.replayed.total() - replayed_before == replays * one_cycle
    wall_s = wall_cycle_time(step, u0, f)
    assert 0 < device_s < wall_s


@pytest.mark.cuda
def test_predicted_staged_solve_at_255_on_the_card_matches_the_cpu(cuda):
    from evostencils_torch.backend.device_solve import staged_solver_for_expression

    problem = poisson_2d(4, 8, dtype=torch.float32)
    outcomes = {}
    for device in ("cpu", cuda):
        expression = _textbook(problem, 2, 2)
        generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device)
        _, rho, _ = generator.generate_and_evaluate(expression, evaluation_samples=1)
        solve, f64_rhs = staged_solver_for_expression(
            CycleLowering(torch.float32, device), expression, _terminals(problem)[1][0].operator,
            problem, generator, lowering64=CycleLowering(torch.float64, device, use_kernels=False),
            rho=rho, calibrate_floor=True, target=1e-10)
        _, f32 = problem.initial_state(torch.float32, device=device)
        outcomes[str(device)] = solve(f32, f64_rhs)
    (c_cpu, rel_cpu, s_cpu), (c_gpu, rel_gpu, s_gpu) = outcomes["cpu"], outcomes[str(cuda)]
    assert rel_cpu <= 1e-10 and rel_gpu <= 1e-10, outcomes
    assert abs(c_gpu - c_cpu) <= 2 and abs(s_gpu - s_cpu) <= 1, outcomes


@pytest.mark.cuda
def test_trace_writes_a_chrome_trace_with_device_events(cuda, tmp_path):
    from evostencils_torch.utils import profiling

    problem = poisson_2d(5, 9, dtype=torch.float32)
    step = CycleLowering(torch.float32, cuda).lower(_textbook(problem, 2, 1))
    u0, f = problem.initial_state(torch.float32, device=cuda)
    step(u0, f)
    with profiling.trace(str(tmp_path), device=cuda) as traced:
        step(u0, f)
        torch.cuda.synchronize()
    assert os.path.getsize(traced.path) > 0
    device_events = [e for e in traced.profiler.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("rb_sweep_kernel" in e.name for e in device_events)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_parsed_poisson_champion_on_the_card_matches_the_cpu(cuda):
    """The exafile champion on the problem parsed from
    artifacts/problem_specs/2D_FD_Poisson_fromL2.exa2 (levels 5-9, 511²,
    float32): the card through the sweep kernel at every level where the
    champion smooths red-black, within 2 % in ρ and ±1 iteration of the CPU,
    and to the digit of poisson_2d on the card."""
    from evostencils_torch.problems import load_problem_file
    from evostencils_torch.utils.champions import parse_champion_file

    tree_string = parse_champion_file(
        os.path.join(ROOT, "artifacts", "exafile_poisson_champion_r5.txt"))[0]
    parsed = load_problem_file(
        os.path.join(ROOT, "artifacts", "problem_specs", "2D_FD_Poisson_fromL2.exa2"))
    results = {}
    for name, problem, device in (("card", parsed, cuda), ("cpu", parsed, "cpu"),
                                  ("hand", poisson_2d(5, 9, dtype=torch.float32), cuda)):
        pset = _terminals(problem)[0]
        expr = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
        rb_sweep.launches.clear()
        results[name] = TorchProgramGenerator(problem, device=device).generate_and_evaluate(
            expr, evaluation_samples=1)[1:] + (dict(rb_sweep.launches),)
    (rho, it, launches), (rho_cpu, it_cpu, _) = results["card"], results["cpu"]
    assert 0 < rho < 1 and abs(rho - rho_cpu) <= 0.02 * rho_cpu and abs(it - it_cpu) <= 1
    assert results["hand"] == results["card"]
    # The champion smooths red-black at 127²-511²; at 63² only with
    # single-colour and block Jacobi, which take no kernel.
    assert sorted(launches) == [(127, 127), (255, 255), (511, 511)], launches
    assert all(count > 0 for count in launches.values()), launches


@pytest.mark.cuda
def test_thread_pool_dispatcher_on_the_card_matches_serial(cuda):
    """Two threads share the card: each V(2,1) ω variant's ρ and iterations
    and the kernel's launches by shape are those of a serial run."""
    from evostencils_torch.parallel.dispatch import SerialDispatcher, ThreadPoolDispatcher

    problem = poisson_2d(5, 9, dtype=torch.float32)
    terminals = _terminals(problem)[1]
    cycles = [reference_cycles.generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=omega)
              for omega in (0.8, 0.9, 1.0, 1.1)]
    outcomes = []
    for dispatcher in (SerialDispatcher(), ThreadPoolDispatcher(2)):
        generator = TorchProgramGenerator(problem, device=cuda)
        rb_sweep.launches.clear()
        results = dispatcher.map(
            lambda c: generator.generate_and_evaluate(c, evaluation_samples=1), cycles)
        torch.cuda.synchronize()
        outcomes.append(([(rho, it) for _, rho, it in results], dict(rb_sweep.launches)))
    assert outcomes[1] == outcomes[0]
    assert all(0 < rho < 1 for rho, _ in outcomes[0][0]) and outcomes[0][1]


@pytest.mark.cuda
def test_evaluation_on_graphs_matches_the_eager_bodies(cuda):
    """The bench champion at 511² and a Helmholtz V(2,1) at 31² with the
    measurement loops on CUDA graphs and with cuda_graphs=False: the
    champion's ρ within 1e-6 with equal counts and stage lengths, the
    replays launching the kernel; Helmholtz with the same verdict."""
    from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file

    problem = poisson_2d(5, 9, dtype=torch.float32)
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields, depth=4,
        maximum_local_system_size=8)
    tree_string, omegas = parse_champion_file(
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                     "poisson2d_champion_r2_tuned.txt"))
    champion = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
    assert apply_stored_omegas(champion, omegas, label="test champion")
    outcomes = {}
    rb_sweep.clear_counts()
    for mode in (True, False):
        generator = TorchProgramGenerator(
            problem, dtype=torch.float32, iteration_limit=500, device=cuda, cuda_graphs=mode)
        _, rho, iterations = generator.generate_and_evaluate(champion, evaluation_samples=1)
        outcomes[mode] = (rho, iterations, generator.last_cycle_solve)
        assert (generator.graph_cache is not None) == mode
    assert abs(outcomes[True][0] - outcomes[False][0]) <= 1e-6 * outcomes[False][0]
    assert outcomes[True][1:] == outcomes[False][1:] and outcomes[True][1] == 10
    assert rb_sweep.replayed.total() > 0

    helmholtz = helmholtz_2d(3, 5, k=20.0, dtype=torch.complex128)
    _, terminals = generate_primitive_set(
        helmholtz.approximation(), helmholtz.rhs(), 2, helmholtz.coarsening_factors,
        helmholtz.max_level, helmholtz.equations, helmholtz.operators, helmholtz.fields,
        depth=2, maximum_local_system_size=8)
    cycle = reference_cycles.generate_v_cycle(terminals, helmholtz.rhs(), 2, 1, omega=0.6)
    counts = {}
    for mode in (True, False):
        generator = TorchProgramGenerator(helmholtz, dtype=torch.complex128, device=cuda,
                                          cuda_graphs=mode)
        _, rho, iterations = generator.generate_and_evaluate(cycle, evaluation_samples=1)
        counts[mode] = (iterations, generator.last_outer_solve)
        assert rho < 1.0
    # The same verdict; the count of a run of about 20 iterations within
    # ±2 (tests/test_torch_helmholtz.py's band), equal expected.
    (it_graphs, outer_graphs), (it_eager, outer_eager) = counts[True], counts[False]
    assert abs(it_graphs - it_eager) <= 2
    assert (outer_graphs["probe"], outer_graphs["stages"]) == (
        outer_eager["probe"], outer_eager["stages"])


@pytest.mark.cuda
def test_a_new_structure_of_registered_branches_captures_nothing_on_the_card(cuda):
    """Textbook V(2,2), then V(1,2) and V(3,1) at other ω through one
    generator on graphs at 511²: the later structures capture no graph,
    and each fitness equals its eager run's (ρ, counts, stage lengths)."""
    from evostencils_torch.backend import graphs

    problem = poisson_2d(5, 9, dtype=torch.float32)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields, depth=4,
        maximum_local_system_size=8)
    on_graphs = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=500,
                                      device=cuda)
    eager = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=500,
                                  device=cuda, cuda_graphs=False)
    captures = []
    for pre, post, omega in ((2, 2, 1.0), (1, 2, 0.9), (3, 1, 1.1)):
        cycle = reference_cycles.generate_v_cycle(terminals, problem.rhs(), pre, post,
                                                  omega=omega)
        before = graphs.counters.captures
        got = on_graphs.generate_and_evaluate(cycle, evaluation_samples=1)
        captures.append(graphs.counters.captures - before)
        expected = eager.generate_and_evaluate(cycle, evaluation_samples=1)
        assert got[1:] == expected[1:]
        assert on_graphs.last_cycle_solve == eager.last_cycle_solve
    assert captures[0] > 0 and captures[1:] == [0, 0]
    stats = on_graphs.graph_stats()
    assert stats["structures"] == 3
    assert stats["vm_captures"] <= stats["branches_registered"] + stats["glue_bodies"]


@pytest.mark.cuda
def test_predicted_staged_solve_on_graphs_matches_the_eager_bodies(cuda):
    """A predicted, floor-calibrated V(2,2) at 255² on CUDA graphs (the
    default) and with cuda_graphs=False: cycles, stages, rel and the
    measured floor to the bit, and again on the same graphs."""
    from evostencils_torch.backend.device_solve import staged_solver_for_expression

    problem = poisson_2d(4, 8, dtype=torch.float32)
    expression = _textbook(problem, 2, 2)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=cuda)
    _, rho, _ = generator.generate_and_evaluate(expression, evaluation_samples=1)
    _, f32 = problem.initial_state(torch.float32, device=cuda)
    outcomes = {}
    for mode in (None, False):
        solve, f64_rhs = staged_solver_for_expression(
            CycleLowering(torch.float32, cuda), expression, _terminals(problem)[1][0].operator,
            problem, generator, lowering64=CycleLowering(torch.float64, cuda, use_kernels=False),
            rho=rho, calibrate_floor=True, target=1e-10, cuda_graphs=mode)
        outcomes[mode] = (solve(f32, f64_rhs), solve.measured_floor, solve.graphs["captures"])
        if mode is None:
            assert solve(f32, f64_rhs) == outcomes[mode][0]
    assert outcomes[None][:2] == outcomes[False][:2] and outcomes[None][0][1] <= 1e-10
    assert outcomes[None][2] == 5 and outcomes[False][2] == 0


@pytest.mark.cuda
def test_the_verdicts_read_back_is_page_locked_fresh_and_exact(cuda):
    """device_solve.to_host from the card: a float64 field lands in its
    own page-locked buffer with the device's bits, a float32 field as its
    exact float64 values, and a later read or device write leaves an
    earlier result as it was."""
    from evostencils_torch.backend.device_solve import to_host

    u64 = torch.randn(511, 511, dtype=torch.float64, device=cuda)
    e32 = torch.randn(511, 511, dtype=torch.float32, device=cuda)
    first, e_host = to_host((u64, e32))
    assert first.dtype == np.float64 and e_host.dtype == np.float64
    assert torch.from_numpy(first).is_pinned()
    assert np.array_equal(first.view(np.int64), u64.cpu().numpy().view(np.int64))
    assert np.array_equal(e_host, e32.cpu().numpy().astype(np.float64))
    kept = first.copy()
    u64.add_(1.0)
    (second,) = to_host((u64,))
    assert not np.shares_memory(first, second)
    assert np.array_equal(first.view(np.int64), kept.view(np.int64))
    assert np.array_equal(second, u64.cpu().numpy())


@pytest.mark.cuda
def test_fas_champion_on_graphs_matches_the_eager_bodies(cuda):
    """The stored FAS champion at levels 5-9 (511²) in float32 on CUDA
    graphs and with cuda_graphs=False: ρ, iterations and the stage's
    executed count to the bit, one loop captured, no kernel launch."""
    problem = fas.fas_2d(5, 9, dtype=torch.float32)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                           "fas_champion_r5.txt")) as f:
        tree_string = "".join(line for line in f if not line.startswith("#")).strip()
    outcomes = {}
    before = rb_sweep.launches.total()
    for mode in (True, False):
        generator = TorchProgramGenerator(problem, dtype=torch.float32, device=cuda,
                                          cuda_graphs=mode)
        optimizer = Optimizer.for_problem(problem, program_generator=generator,
                                          rng=random.Random(0))
        _, rho, iterations = optimizer.generate_and_evaluate_program_from_grammar_representation(
            tree_string, 8, evaluation_samples=1)
        outcomes[mode] = (rho, iterations, generator.last_cycle_solve)
        assert (generator.graph_cache is not None and len(generator.graph_cache) == 1) == mode
    assert outcomes[True] == outcomes[False] and outcomes[True][0] < 0.25
    assert rb_sweep.launches.total() == before


@pytest.mark.cuda
def test_per_cycle_time_refuses_a_cycle_with_a_host_sync(cuda):
    """Last in the file: a failed capture is the one test here that leaves
    the stream's capture aborted."""
    from evostencils_torch.utils.timing import per_cycle_time

    problem = poisson_2d(3, 5, dtype=torch.float32)
    step = CycleLowering(torch.float32, cuda).lower(_textbook(problem, 2, 1))
    u0, f = problem.initial_state(torch.float32, device=cuda)

    def synchronizing(u, f):
        out = step(u, f)
        float(out[0].sum())  # a host sync: cannot be captured
        return out

    with pytest.raises(CudaGraphError, match="cannot be captured"):
        per_cycle_time(synchronizing, u0, f, iters=2, repeats=1)


@pytest.mark.cuda
@pytest.mark.parametrize("members", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(63, 63), (511, 511), (1023, 1023), (161, 96)])
def test_batched_kernel_is_its_single_launches(cuda, members, shape):
    # One launch for the members, counted under (members, rows, cols): bit
    # for bit the single launch on each member with its own ω, and within
    # 5e-5 of the batched plain version.
    stencil = constant.Stencil(ENTRIES["9-point"])
    rng = np.random.default_rng(members)
    u, f = (torch.from_numpy(rng.standard_normal((members,) + shape).astype(np.float32)).to(cuda)
            for _ in range(2))
    omegas = torch.linspace(0.7, 1.3, members, device=cuda)
    key = (members,) + shape
    before = rb_sweep.launches[key]
    out = rb_sweep.red_black_collective_jacobi_sweep(u, f, omegas, stencil)
    torch.cuda.synchronize()
    assert rb_sweep.launches[key] == before + 1
    singles = torch.stack([rb_sweep.red_black_collective_jacobi_sweep(u[b], f[b], omegas[b], stencil)
                           for b in range(members)])
    assert torch.equal(out, singles)
    assert float((out - rb_sweep.rb_sweep_reference(u, f, omegas, stencil)).abs().max()) < 5e-5


@pytest.mark.cuda
def test_batched_kernel_refuses_more_members_than_the_largest_bucket(cuda):
    u = torch.zeros((rb_sweep.MAX_MEMBERS + 1, 31, 31), device=cuda)
    with pytest.raises(ValueError):
        rb_sweep.red_black_collective_jacobi_sweep(u, u, 1.0, constant.Stencil(ENTRIES["5-point"]))


@pytest.mark.cuda
def test_batched_group_on_the_card_matches_its_single_evaluations(cuda):
    # The champion's ω variants at 127² (levels 3-7): one batched loop on
    # the bucket's interpreter, the sweeps batched launches, each member's ρ
    # within 1e-5 relative of its own evaluation and its iterations equal
    # (±1 only where ρ sits on a boundary of that band).
    from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file

    problem = poisson_2d(3, 7, dtype=torch.float32)
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=4, maximum_local_system_size=8)
    tree_string, stored = parse_champion_file(
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "artifacts",
                      "poisson2d_champion_r2_tuned.txt"))
    rng = np.random.default_rng(13)
    members = []
    for i in range(5):
        expr = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
        omegas = stored if i == 0 else np.clip(
            np.asarray(stored) * rng.uniform(0.85, 1.1, len(stored)), 0.1, 1.9)
        apply_stored_omegas(expr, list(omegas), label="variant")
        members.append(expr)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=cuda)
    rb_sweep.clear_counts()
    group = generator.generate_and_evaluate_group(members, evaluation_samples=1)
    assert generator.groups_batched == 1 and generator.batched_members == 5
    assert any(len(key) == 3 and key[0] == 8 for key in rb_sweep.launches)
    singles = [generator.generate_and_evaluate(e, evaluation_samples=1) for e in members]
    for (_, rho, it), (_, rho_single, it_single) in zip(group, singles):
        assert abs(rho - rho_single) <= 1e-5 * rho_single
        assert abs(it - it_single) <= 1
    assert 8 in generator.graph_stats()["buckets"]


@pytest.mark.cuda
def test_a_probe_state_hit_scores_as_its_build_on_graphs(cuda):
    """The search pool's first 8 trees at 511² on CUDA graphs: a fresh
    generator's first pass (one probe state built, every graph captured),
    then each tree with its probe state built anew and then from the cache.
    The build and the hit give the first pass's ρ, iterations and class,
    and the same graph replays and host reads."""
    from evostencils_torch.backend import graphs

    problem = poisson_2d(5, 9, dtype=torch.float32)
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields, depth=4,
        maximum_local_system_size=8)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "portbench", "data",
                           "poisson2d_511_trees.txt")) as fh:
        trees = [gp.parse_tree(line.strip(), pset) for line in fh if line.strip()][:8]
    generator = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=500,
                                      device=cuda)
    infinity = 1e100

    def evaluate(tree):
        before = graphs.counters.as_dict()
        t, rho, iterations = generator.generate_and_evaluate(
            gp.compile_tree(tree, pset)[0], infinity=infinity, evaluation_samples=1)
        torch.cuda.synchronize()
        after = graphs.counters.as_dict()
        verdict = ("poisoned" if not rho < infinity else
                   "diverged" if not t < infinity else "converged")
        return (rho, iterations, verdict), tuple(
            after[name] - before[name] for name in ("replays", "host_reads"))

    first = [evaluate(tree)[0] for tree in trees]
    assert (generator.probe_state_builds, generator.probe_state_hits) == (1, 7)
    assert any(verdict == "converged" for _, _, verdict in first)
    for tree, fitness in zip(trees, first):
        generator._probe_states.clear()
        built = evaluate(tree)
        hits = generator.probe_state_hits
        hit = evaluate(tree)
        assert generator.probe_state_hits == hits + 1
        assert built[0] == hit[0] == fitness
        assert built[1] == hit[1] and hit[1][0] > 0 and hit[1][1] > 0
    assert generator.probe_state_builds == 1 + len(trees)
