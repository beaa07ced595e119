"""The measurement loops' bodies, which the card captures in CUDA graphs
(evostencils_torch/backend/graphs.py), on the CPU.

A CPU has no graphs, so these tests hold what a capture relies on:

* nothing inside a body reads a value to the host or copies one to the
  device, after a warm-up call: a guard makes `Tensor.item`, `__bool__`,
  `__float__`, `__int__`, `__index__`, `tolist`, `cpu` and `numpy`, and
  `torch.tensor`, `torch.as_tensor` and `torch.from_numpy`, raise around one
  cycle of each of the 16 bench trees and the stored champion (2D Poisson,
  levels 2-6, float32; the VM step and the lowered step), around the stage
  and power glue bodies, and around one outer BiCGStab iteration
  (Helmholtz, levels 3-5).  A Python scalar read from ω, or a tensor made
  from host data inside a step, would be frozen into a graph at its
  capture;
* the VM step with ω as a float32 tensor gives the float-ω step to the bit,
  and one interpreter with one cached glue loop serves programs with the
  same opcodes and other ω, each with its own result, and programs of other
  opcodes, capturing only the branches they are first to use;
* the restructured stage, power and BiCGStab loops run eagerly give the
  port's earlier eager loops exactly (copied here as the oracle), and the
  JAX package's `stage_raw`, `power_raw` and outer solve within the
  tolerances of tests/test_torch_slice.py and tests/test_torch_helmholtz.py;
* a generator whose graphs replay bodies eagerly (`capture` replaced by an
  eager stand-in) scores every individual as the eager generator does,
  with one interpreter and one glue loop per problem for the VM and one
  loop per lowered structure; the cache's LRU bound; replays count the
  kernels' recorded launches, and the capture layer names no kernel.
"""

import ast
import collections
import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.problems import helmholtz as jax_helmholtz
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch import CudaGraphError, CudaKernelError
from evostencils_torch.backend import graphs
from evostencils_torch.backend.evaluation import (
    PowerLoop, StageLoop, StepCycle, TorchProgramGenerator)
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import CycleVM
from evostencils_torch.grammar import gp
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.ops import _build, krylov, rb_sweep, stencil_kernel
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.problems import fas, helmholtz
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from torch_parity import (  # noqa: F401 (eager_graphs: a fixture)
    JAX, PORT, EagerCapture, Side, eager_capture, eager_graphs, jax_state, no_host_reads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")
INFINITY = 1e100

def test_the_guard_catches_a_host_read():
    x = torch.ones(3)
    with no_host_reads():
        with pytest.raises(AssertionError, match="item"):
            x.sum().item()
        with pytest.raises(AssertionError, match="__float__"):
            float(x.sum())
        with pytest.raises(AssertionError, match="tensor"):
            torch.tensor(1.0)
    assert x.sum().item() == 3.0


# ---- the bench trees and the champion, 2D Poisson levels 2-6 ------------

def _bench():
    problem = poisson_2d(min_level=2, max_level=6, dtype=torch.float32)
    side = Side(PORT, problem, depth=4)
    rng = random.Random(20260816)
    trees = [gp.gen_grow(side.pset, 2, 16, rng=rng) for _ in range(16)]
    expressions = [gp.compile_tree(t, side.pset)[0] for t in trees]
    tree_string, omegas = parse_champion_file(CHAMPION)
    champion = side.compile(tree_string)
    assert apply_stored_omegas(champion, omegas, label="test champion")
    return problem, expressions + [champion]


BENCH = _bench()


def _state(problem, seed=3):
    rng = np.random.default_rng(seed)
    shape = problem.finest_grid[0].interior_shape if isinstance(
        problem.finest_grid, list) else problem.finest_grid.interior_shape
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))


def _finest_shape(problem):
    u0, _ = problem.initial_state(torch.float32, device="cpu")
    return tuple(u0[0].shape)


@pytest.mark.parametrize("index", range(len(BENCH[1])))
def test_no_host_read_inside_one_cycle(index):
    """One cycle of bench tree `index` (16: the champion) through the VM
    and lowered from the IR, after a warm-up call."""
    problem, expressions = BENCH
    expr = expressions[index]
    lowering = CycleLowering(torch.float32, "cpu")
    rng = np.random.default_rng(index)
    shape = _finest_shape(problem)
    u = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),)
    f = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),)
    steps = []
    program = CycleVM(lowering, problem, problem.max_level).translate(expr)
    if program is not None:
        vm_step = CycleVM(lowering, problem, problem.max_level).make_step()
        on_device = program._replace(omegas=torch.from_numpy(program.omegas))
        steps.append(lambda: vm_step(u, f, on_device))
    lowered, omega_values = lowering.lower_parameterized(expr)
    omegas = torch.tensor(omega_values, dtype=torch.float32)
    steps.append(lambda: lowered(u, f, omegas))
    for step in steps:
        expected = step()
        with no_host_reads():
            got = step()
        assert torch.equal(got[0], expected[0])


def test_no_host_read_inside_the_stage_and_power_bodies():
    """The glue bodies of both loops, around the eager cycle and around
    the interpreter (with the eager capture stand-in: its warm-up and its
    replays run under the guard), and one host step of each loop."""
    problem, expressions = BENCH
    generator = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=100,
                                      device="cpu")
    champion = expressions[-1]
    (stage, power, operator), program = generator._build_solver(champion)
    vm = generator._vm_for(problem.max_level)

    u0, f = _state(problem)
    u0, f = (u0,), (f,)

    def residual_norm(u, rhs):
        return sops.l2_norm(sops.tree_sub(rhs, generator.lowering.system_apply(operator, u)))

    interpreter = graphs.Interpreter(vm.make_state())
    saved, graphs.capture = graphs.capture, eager_capture
    try:
        for cycle in (StepCycle(vm.make_step(), program, u0), interpreter):
            stage_loop = StageLoop(cycle, residual_norm)
            stage_loop.load(u0, f, program)
            power_loop = PowerLoop(cycle, sops.l2_norm)
            # Warm: the interpreter captures the branches at their first use.
            for loop, host_step in ((stage_loop, stage_loop.step), (power_loop, power_loop.block)):
                for name in loop.bodies:
                    loop.run(name)
                host_step()
            power_loop.load(u0, tuple(torch.zeros_like(x) for x in f), program)
            with no_host_reads():
                for loop, host_step in ((stage_loop, stage_loop.step),
                                        (power_loop, power_loop.block)):
                    for name in loop.bodies:
                        loop.run(name)
                    host_step()
            assert int(stage_loop.it) == 2 and math.isfinite(float(power_loop.rate))
    finally:
        graphs.capture = saved
    assert interpreter.captures == 1 + len(set(program.opcodes.tolist()))


# ---- ω as a device tensor -----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_vm_step_with_tensor_omega_equals_the_float_omega_step(dtype):
    """The parent's VM step read ω as Python floats (float32-rounded); the
    0-d views of one float32 tensor give the same bits."""
    if dtype == torch.complex128:
        problem = helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=dtype)
        expr = Side(PORT, problem).cycle(2, 1, 0.6)
    else:
        problem, expressions = BENCH
        expr = expressions[-1]
    vm = CycleVM(CycleLowering(dtype, "cpu"), problem, problem.max_level)
    program = vm.translate(expr)
    assert program is not None
    u0, f = problem.initial_state(dtype, device="cpu")
    rng = np.random.default_rng(4)
    u0 = tuple(torch.from_numpy(rng.standard_normal(x.shape)).to(dtype) for x in u0)

    # The parent's interpreter: the same branches, ω as Python floats.
    state = ((tuple(u0),) + tuple(
        tuple(torch.zeros(s, dtype=dtype) for s in shapes) for shapes in vm._shapes[1:]),
        (tuple(f),) + tuple(
        tuple(torch.zeros(s, dtype=dtype) for s in shapes) for shapes in vm._shapes[1:]))
    for op, omega in zip(program.opcodes.tolist(), program.omegas.tolist()):
        state = vm._branches[op](state, omega)
    expected = state[0][0]

    got = vm.make_step()(u0, f, program._replace(omegas=torch.from_numpy(program.omegas)))
    for g, e in zip(got, expected):
        assert torch.equal(g, e)


class FakeGraphCache(graphs.GraphCache):
    """A GraphCache whose captures replay the bodies eagerly and whose
    entries weigh what their tensors weigh."""

    def _capture(self, loop):
        loop._graphs = {name: graphs.Graph(EagerCapture(getattr(loop, name)))
                        for name in loop.bodies}
        loop.nbytes = sum(t.numel() * t.element_size() for value in vars(loop).values()
                          for t in graphs._tensors(value))

    def _release(self):
        pass


def test_one_cached_loop_serves_programs_with_the_same_opcodes(eager_graphs):
    """Two ω variants of the champion: the second reuses the first's
    cached power loop and interpreter graphs, captures nothing, and still
    gets its own rate.  Then a bench tree of other opcodes: the same glue
    loop and interpreter, new captures only for branches it is the first
    to use."""
    problem, expressions = BENCH
    cached = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    cached.graph_cache = graphs.GraphCache()
    eager = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    tree_string, omegas = parse_champion_file(CHAMPION)
    side = Side(PORT, problem, depth=4)
    variants = []
    for scale in (1.0, 0.8):
        expr = side.compile(tree_string)
        apply_stored_omegas(expr, [w * scale for w in omegas], label="variant")
        variants.append(expr)
    tree = next(e for e in expressions[:-1] if cached._vm_program(e)[1] is not None)
    rates, captures = [], []
    for expr in variants + [tree]:
        (_, power, _), program = cached._build_solver(expr)
        (_, eager_power, _), eager_program = eager._build_solver(expr)
        _, _, e0, zf = cached._probe_state(expr)
        before = graphs.counters.captures
        registered = set(cached._interpreters[cached._vm_for(problem.max_level)]._graphs
                         ) if cached._interpreters else set()
        rates.append(power(e0, zf, program)[0])
        new = set(program.opcodes.tolist()) - registered
        captures.append((graphs.counters.captures - before, len(new)))
        assert rates[-1] == eager_power(e0, zf, eager_program)[0]
    assert len(cached.graph_cache) == 1 and len(cached._interpreters) == 1
    assert rates[0] != rates[1]
    # The first run captures the glue (2), the prologue and its branches;
    # the ω variant nothing; the other tree only its new branches.
    assert captures[0] == (2 + 1 + captures[0][1], captures[0][1])
    assert captures[1][0] == 0 and captures[2][0] == captures[2][1]


# ---- the restructured loops against the port's eager loops and JAX ------

def _parent_stage_power(generator, step, operator):
    """The port's stage and power loops as evostencils_torch/backend/
    evaluation.py had them before their bodies moved onto static buffers."""
    lowering = generator.lowering
    cap = generator.iteration_limit
    np_dt = generator._np_real
    target = np_dt(generator.measure_reduction)
    rho_required = np_dt(generator.epsilon ** (1.0 / cap))
    grace, divergence, patience = np_dt(10.0), np_dt(1e8), 5

    def residual_norm(u, f):
        return sops.l2_norm(sops.tree_sub(f, lowering.system_apply(operator, u)))

    def stage(u0, rhs, omegas):
        res0 = np_dt(residual_norm(u0, rhs).item())
        u, res, it, best_res, best_it, best_u = u0, res0, 0, res0, 0, u0
        while (it < cap and res > target * res0 and res < divergence * res0
               and np.isfinite(res)
               and (it < 25 or res < grace * res0 * rho_required ** np_dt(it))
               and it - best_it < patience):
            u = step(u, rhs, omegas)
            res = np_dt(residual_norm(u, rhs).item())
            it += 1
            if res < best_res:
                best_it, best_u, best_res = it, u, res
        return best_res, res0, best_it, best_u, it

    def one_block(e, zf, omegas):
        log_acc = None
        for _ in range(10):
            e = step(e, zf, omegas)
            n = sops.l2_norm(e)
            safe = torch.where(n > 0, n, 1.0)
            e = tuple(x / safe for x in e)
            log_n = torch.log(torch.where(n > 0, n, torch.finfo(n.dtype).tiny))
            log_acc = log_n if log_acc is None else log_acc + log_n
        return e, np_dt(torch.exp(log_acc / 10).item())

    def power(e0, zf, omegas):
        e, rate = one_block(e0, zf, omegas)
        prev_rate, k = np_dt(0.0), 1
        while (k < 8 and (k < 3 or abs(rate - prev_rate) > np_dt(0.02) * abs(rate))
               and rate < 2.0 and np.isfinite(rate)):
            e, new_rate = one_block(e, zf, omegas)
            prev_rate, rate, k = rate, new_rate, k + 1
        return rate, k * 10

    return stage, power


@pytest.mark.parametrize("index", [0, 3, 16])
def test_stage_and_power_match_the_eager_loops_exactly(index):
    problem, expressions = BENCH
    generator = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=100,
                                      device="cpu")
    expr = expressions[index]
    (stage, power, operator), omega_arg = generator._build_solver(expr)
    vm, program = generator._vm_program(expr)
    step = (vm.make_step() if program is not None
            else generator.lowering.lower_parameterized(expr)[0])
    parent_stage, parent_power = _parent_stage_power(generator, step, operator)
    u0, f, e0, zf = generator._probe_state(expr)
    got, expected = stage(u0, f, omega_arg), parent_stage(u0, f, omega_arg)
    assert got[:3] + (got[4],) == expected[:3] + (expected[4],)
    assert all(torch.equal(g, e) for g, e in zip(got[3], expected[3]))
    assert power(e0, zf, omega_arg) == parent_power(e0, zf, omega_arg)


def _jax_and_port(np_dtype, tree_strings=None):
    jdt = jnp.dtype(np_dtype)
    tdt = torch.float32 if np_dtype == np.float32 else torch.float64
    jax_side = Side(JAX, jax_poisson_2d(3, 5, dtype=jdt), depth=2)
    side = Side(PORT, poisson_2d(3, 5, dtype=tdt), depth=2)
    rng = random.Random(5)
    strings = [str(gp.gen_grow(side.pset, 2, 16, rng=rng)) for _ in range(4)]
    return jax_side, side, strings


def test_power_matches_the_reference_power_raw():
    """float32 rates of the seeded trees and the V(2,2) two-grid cycle
    within 1 % (tests/test_torch_slice.py's band: the summation order
    differs), lowered from the IR on both sides."""
    jax_side, side, strings = _jax_and_port(np.float32)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    port = TorchProgramGenerator(side.problem, dtype=torch.float32, device="cpu")
    strings.append(None)
    compared = 0
    for s in strings:
        je = jax_side.cycle(2, 2, 1.0, levels=2) if s is None else jax_side.compile(s)
        te = side.cycle(2, 2, 1.0, levels=2) if s is None else side.compile(s)
        jax_step, omegas = reference.lowering.lower_parameterized(je)
        _, jax_power = reference._stage_power_fns(jax_step, reference._finest_operator_for(je))
        key = port._structural_key(te)
        _, power = port._stage_power_fns(
            port.lowering.lower_parameterized(te)[0], port._finest_operator_for(te), key)
        _, _, e0, zf = port._probe_state(te)
        rate_ref, _ = jax.jit(jax_power)(jax_state(e0, jnp.float32), jax_state(zf, jnp.float32),
                                         jnp.asarray(omegas, dtype=jnp.float32))
        rate, _ = power(e0, zf, port._omega_vector(te))
        rate_ref = float(rate_ref)
        if math.isfinite(rate_ref) and rate_ref < 2.0:
            assert abs(rate - rate_ref) <= 1e-2 * rate_ref, (s, rate, rate_ref)
            compared += 1
    assert compared >= 2


def test_stage_matches_the_reference_stage_raw():
    """float64 stages to 1e-6 from the problem's initial state: best
    residual within 1e-8 relative, equal best and executed counts
    (tests/test_torch_slice.py's float64 rule)."""
    jax_side, side, strings = _jax_and_port(np.float64)
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, epsilon=1e-6)
    port = TorchProgramGenerator(side.problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    for s in strings + [None]:
        je = jax_side.cycle(2, 2, 1.0, levels=2) if s is None else jax_side.compile(s)
        te = side.cycle(2, 2, 1.0, levels=2) if s is None else side.compile(s)
        jax_step, omegas = reference.lowering.lower_parameterized(je)
        jax_stage, _ = reference._stage_power_fns(jax_step, reference._finest_operator_for(je))
        stage, _ = port._stage_power_fns(
            port.lowering.lower_parameterized(te)[0], port._finest_operator_for(te),
            port._structural_key(te))
        u0, f, _, _ = port._probe_state(te)
        best_res_ref, res0_ref, best_it_ref, _, executed_ref = jax.jit(jax_stage)(
            jax_state(u0, jnp.float64), jax_state(f, jnp.float64),
            jnp.asarray(omegas, dtype=jnp.float32))
        best_res, res0, best_it, _, executed = stage(u0, f, port._omega_vector(te))
        assert res0 == pytest.approx(float(res0_ref), rel=1e-12)
        assert abs(best_res - float(best_res_ref)) <= 1e-8 * float(best_res_ref), s
        assert (best_it, executed) == (int(best_it_ref), int(executed_ref)), s


def _parent_bicgstab(apply_a, apply_m, rhs, max_iterations, target_reduction):
    """The port's eager preconditioned BiCGStab as evostencils_torch/ops/
    krylov.py had it before its iteration moved onto static buffers."""
    def norm(r):
        value = torch.sqrt(torch.real(sops.dot(r, r)))
        return (np.float64 if value.dtype == torch.float64 else np.float32)(value.item())

    x = sops.zeros_like_state(rhs)
    r = tuple(rhs)
    r_hat = p = r
    rho = sops.dot(r_hat, r)
    res0 = norm(r)
    threshold = type(res0)(target_reduction) * res0
    res, it, best_x, best_res = res0, 0, x, res0
    while it < max_iterations and res > threshold and math.isfinite(res):
        p_hat = apply_m(p)
        v = apply_a(p_hat)
        alpha = krylov._safe_div(rho, sops.dot(r_hat, v))
        s = sops.tree_sub(r, sops.tree_scale(alpha, v))
        s_hat = apply_m(s)
        t = apply_a(s_hat)
        omega = krylov._safe_div(sops.dot(t, s), sops.dot(t, t))
        x = sops.tree_add(x, sops.tree_add(sops.tree_scale(alpha, p_hat),
                                           sops.tree_scale(omega, s_hat)))
        r = sops.tree_sub(s, sops.tree_scale(omega, t))
        rho_new = sops.dot(r_hat, r)
        beta = krylov._safe_div(rho_new * alpha, rho * omega)
        p = sops.tree_add(r, sops.tree_scale(beta, sops.tree_sub(p, sops.tree_scale(omega, v))))
        rho = rho_new
        res = norm(r)
        it += 1
        if math.isfinite(res) and res < best_res:
            best_x, best_res = x, res
    if not (math.isfinite(res) and res <= best_res):
        x = best_x
    return x, it, float(min(res if math.isfinite(res) else best_res, best_res))


def _helmholtz_pieces(dtype=torch.complex128, vm=True):
    problem = helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=dtype)
    generator = TorchProgramGenerator(problem, dtype=dtype, device="cpu")
    expr = Side(PORT, problem).cycle(2, 1, 0.6)
    outer = generator._outer_operator_for(expr)
    program = generator._vm_program(expr)[1]
    if vm:
        step, omega_arg = generator._vm_for(problem.max_level).make_step(), program
    else:
        step, omega_arg = (generator.lowering.lower_parameterized(expr)[0],
                           generator._omega_vector(expr))
    f = generator._to_device(problem.initial_state(dtype)[1])
    cycle = StepCycle(step, omega_arg, f)
    cycle.load(omega_arg)

    def apply_m(state):
        return cycle(sops.zeros_like_state(state), state)

    def apply_a(state):
        return generator.lowering.system_apply(outer, state)

    return generator, expr, apply_a, apply_m, f


@pytest.mark.parametrize("vm", [True, False])
def test_no_host_read_inside_one_bicgstab_iteration(vm):
    _, _, apply_a, apply_m, f = _helmholtz_pieces(vm=vm)
    loop = krylov.BicgstabLoop(apply_a, apply_m, f)
    for d, x in zip(loop.rhs, f):
        d.copy_(x)
    loop.run("start")
    loop.iteration()
    with no_host_reads():
        loop.run("start")
        loop.iteration()
    assert math.isfinite(float(loop.res))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_bicgstab_loop_matches_the_eager_iteration_exactly(dtype):
    """Capped at 60 (the Helmholtz evolution's cap): the same count, the
    same residual and the same iterate, to the bit."""
    _, _, apply_a, apply_m, f = _helmholtz_pieces(dtype)
    x, it, res = krylov.preconditioned_bicgstab(apply_a, apply_m, f, 60, 1e-7)
    x_ref, it_ref, res_ref = _parent_bicgstab(apply_a, apply_m, f, 60, 1e-7)
    assert (it, res) == (it_ref, res_ref) and 0 < it <= 60
    assert all(torch.equal(a, b) for a, b in zip(x, x_ref))


def test_bicgstab_loop_matches_the_reference_outer_solve():
    """Eight outer iterations through each package's VM: x and the residual
    norm within 1e-10 (tests/test_torch_helmholtz.py's band for short
    arithmetic)."""
    jax_problem = jax_helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=jnp.complex128)
    reference = JaxProgramGenerator(jax_problem, dtype=jnp.complex128)
    jax_expr = Side(JAX, jax_problem).cycle(2, 1, 0.6)
    jax_vm, jax_program = reference._vm_program(jax_expr)
    jax_solve = reference._outer_solve_raw(
        jax_vm.make_step(), reference._outer_operator_for(jax_expr), 8)
    generator, expr, _, _, f = _helmholtz_pieces()
    vm, program = generator._vm_program(expr)
    solve = generator._outer_solve_raw(vm.make_step(), generator._outer_operator_for(expr), 8)
    x_ref, res_ref, res0_ref, it_ref = jax_solve(
        None, (jnp.asarray(f[0].numpy()),), jax_program.as_arguments())
    x, res, res0, it = solve(f, program)
    assert it == int(it_ref) == 8
    assert abs(res - float(res_ref)) <= 1e-10 * float(res_ref)
    x_ref = np.asarray(x_ref[0])
    assert np.abs(x[0].numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


# ---- the generator on a cache that replays eagerly ----------------------

def test_a_cached_generator_scores_as_the_eager_one(eager_graphs):
    """The bench trees and the champion, one by one and as a group of ω
    variants: ρ, iterations and every stage's executed count equal; one
    cached stage and power loop for every VM program, and one each per
    lowered structure; the group adds its bucket's batched power loop."""
    problem, expressions = BENCH
    cached = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=100,
                                   device="cpu")
    cached.graph_cache = graphs.GraphCache()
    eager = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=100,
                                  device="cpu")
    keys = set()
    for expr in expressions[:6] + expressions[-1:]:
        got = cached.generate_and_evaluate(expr, evaluation_samples=1)
        expected = eager.generate_and_evaluate(expr, evaluation_samples=1)
        assert got[1:] == expected[1:], canonical_string(expr)
        assert cached.last_cycle_solve == eager.last_cycle_solve
        vm, program = cached._vm_program(expr)
        keys.add("__vm__" if program is not None else cached._structural_key(expr))
    assert len(keys) <= len(cached.graph_cache) <= 2 * len(keys)
    size = len(cached.graph_cache)
    side = Side(PORT, problem, depth=4)
    tree_string, omegas = parse_champion_file(CHAMPION)
    variants = []
    for scale in (1.0, 0.9, 1.05):
        expr = side.compile(tree_string)
        apply_stored_omegas(expr, [w * scale for w in omegas], label="variant")
        variants.append(expr)
    group = cached.generate_and_evaluate_group(variants, evaluation_samples=1)
    expected = eager.generate_and_evaluate_group(variants, evaluation_samples=1)
    assert [g[1:] for g in group] == [e[1:] for e in expected]
    assert cached.groups == cached.groups_batched == 1
    assert len(cached.graph_cache) == size + 1 and len(cached._batched_interpreters) == 1


def test_a_cached_generator_solves_helmholtz_as_the_eager_one(eager_graphs):
    """k = 20, levels 3-5, complex128: the probe and the staged solve of
    both cycles share one BiCGStab glue loop on the interpreter; counts, ρ
    and the probe's verdict equal."""
    problem = helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=torch.complex128)
    side = Side(PORT, problem)
    cached = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
    cached.graph_cache = graphs.GraphCache()
    eager = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
    for pre, post, omega in ((2, 1, 0.6), (1, 2, 0.7)):
        expr = side.cycle(pre, post, omega)
        got = cached.generate_and_evaluate(expr, evaluation_samples=1)
        expected = eager.generate_and_evaluate(expr, evaluation_samples=1)
        assert got[1:] == expected[1:] and got[0] < INFINITY
        assert cached.last_outer_solve == eager.last_outer_solve
    assert len(cached.graph_cache) == 1 and len(cached._interpreters) == 1


# ---- the cache, the counts and the flag ----------------------------------

class Weighing(graphs.Loop):
    bodies = ("body",)

    def __init__(self, nbytes):
        super().__init__()
        self.weight = nbytes

    def body(self):
        pass


class WeighingCache(FakeGraphCache):
    def _capture(self, loop):
        super()._capture(loop)
        loop.nbytes = loop.weight


def test_graph_cache_evicts_the_least_recently_used_beyond_its_bound():
    graphs.counters.reset()
    cache = WeighingCache(max_bytes=250)
    made = []

    def make(nbytes):
        def build():
            made.append(nbytes)
            return Weighing(nbytes)
        return build

    a = cache.get("a", make(100))
    cache.get("b", make(100))
    assert cache.get("a", make(100)) is a  # a is now the most recent
    cache.get("c", make(100))  # 300 > 250: b goes
    assert list(cache._entries) == ["a", "c"] and cache.bytes_held == 200
    cache.get("d", make(400))  # alone above the bound: the newest stays
    assert list(cache._entries) == ["d"] and cache.bytes_held == 400
    assert made == [100, 100, 100, 400] and graphs.counters.evictions == 3
    assert graphs.bytes_held() >= 400
    cache.clear()
    assert len(cache) == 0 and cache.bytes_held == 0


class _OnCard:
    """A launch's input as a CUDA tensor shows it to ops/_build.count,
    without a card."""

    device = torch.device("cuda", 0)


# A kernel's counter registered by a module that backend/graphs.py never
# names: the capture layer records and replays it as it does the two
# kernels'.
STUB = _build.counter()
KERNEL_COUNTERS = (rb_sweep.launches, stencil_kernel.launches, stencil_kernel.plain, STUB)
# What each case's capture counts: (counter, key) pairs, a refusal where
# the counter is the stencil gate's.
RECORDED = {
    "sweep": [(rb_sweep.launches, (63, 63))] * 2 + [(rb_sweep.launches, (127, 127))],
    "stencil": [(stencil_kernel.launches, ("apply", (511, 511)))] * 2
    + [(stencil_kernel.launches, ("restrict", (255, 255))), (stencil_kernel.plain, "dtype")],
    "empty": [],
    "stub": [(STUB, "launch")] * 2,
}


@pytest.mark.parametrize("case", RECORDED)
def test_replays_count_the_launches_their_capture_recorded(case, monkeypatch):
    """What ops/_build.count is given during graphs.capture goes to the
    capture's one recording, whichever module owns the counter; each replay
    adds it to that counter and to its replayed part, an eager launch
    counts once, and an empty recording adds nothing.  Under a capture
    that graphs.capture did not start a launch raises and a refusal counts
    at once."""
    _build.clear(*KERNEL_COUNTERS)
    graphs.counters.reset()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with _build.recording() as recorded:
        for counter, key in RECORDED[case]:
            _build.count(counter, key, _OnCard(), refusal=counter is stencil_kernel.plain)
    assert not any(KERNEL_COUNTERS)  # a capture launches nothing
    with pytest.raises(CudaKernelError, match="did not start"):
        _build.count(STUB, "elsewhere", _OnCard())
    _build.count(stencil_kernel.plain, "grad", _OnCard(), refusal=True)
    assert stencil_kernel.plain == {"grad": 1} and not STUB
    monkeypatch.undo()

    _build.clear(*KERNEL_COUNTERS)
    graph = graphs.Graph(EagerCapture(lambda: None), recorded)
    assert bool(graph.recorded) == bool(RECORDED[case])
    rb_sweep.count_launch((63, 63))  # an eager launch
    for _ in range(3):
        graph.replay()
    expected = {id(counter): collections.Counter() for counter in KERNEL_COUNTERS}
    for counter, key in RECORDED[case]:
        expected[id(counter)][key] += 3
    for counter in KERNEL_COUNTERS:
        assert _build.replayed(counter) == expected[id(counter)]
    expected[id(rb_sweep.launches)][(63, 63)] += 1
    for counter in KERNEL_COUNTERS:
        assert counter == expected[id(counter)]
    assert rb_sweep.replayed is _build.replayed(rb_sweep.launches)
    assert graphs.counters.replays == 3
    _build.clear(*KERNEL_COUNTERS)


def test_the_capture_layer_and_the_build_name_no_kernel():
    """backend/graphs.py imports no kernel's module and ops/_build.py names
    no kernel entry point: a new kernel touches its source, its wrapper and
    the ops that call it, nothing in backend/."""
    package = os.path.join(ROOT, "evostencils_torch")
    for path in ("backend/graphs.py", "ops/_build.py"):
        with open(os.path.join(package, path)) as f:
            source = f.read()
        imported = []
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Import):
                imported += [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                imported += [f"{node.module}.{alias.name}" for alias in node.names]
        assert not [name for name in imported
                    if "rb_sweep" in name or "stencil_kernel" in name], (path, imported)
        if path == "ops/_build.py":
            assert "rb_sweep_f32" not in source and "stencil2d_" not in source


def test_cuda_graphs_flag_rules():
    problem = poisson_2d(3, 5, dtype=torch.float32)
    assert TorchProgramGenerator(problem, device="cpu").graph_cache is None
    assert TorchProgramGenerator(problem, device="cpu", cuda_graphs=False).graph_cache is None
    with pytest.raises(ValueError, match="no CUDA graphs"):
        TorchProgramGenerator(problem, device="cpu", cuda_graphs=True)
    with pytest.raises(ValueError, match="mesh"):
        TorchProgramGenerator(problem, device="cuda", mesh=object(), cuda_graphs=True)
    assert not issubclass(CudaGraphError, (RuntimeError, ValueError, NotImplementedError))
    # FAS is no longer refused: on a card it takes graphs by default, and
    # asked for them it gets them.
    fas_problem = fas.fas_2d(3, 5, dtype=torch.float32)
    assert TorchProgramGenerator(fas_problem, device="cuda").graph_cache is not None
    assert TorchProgramGenerator(fas_problem, device="cuda", cuda_graphs=True).graph_cache \
        is not None
    with pytest.raises(ValueError, match="mesh"):
        TorchProgramGenerator(fas_problem, device="cuda", mesh=object(), cuda_graphs=True)
