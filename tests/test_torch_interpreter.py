"""The cycle VM's interpreter on the CPU: backend/graphs.Interpreter over
backend/vm.LevelState, with `graphs.capture` replaced by an eager stand-in
(tests/torch_parity.eager_capture: the warm-up runs the body, as on the
card, and a "replay" calls it again).

* For the 16 bench trees and the stored champion (2D Poisson, levels 2-6),
  two cycles through the interpreter give the eager `make_step`'s finest
  iterate bit for bit in float32 and float64, and the JAX package's VM
  within 1e-12 in float64 (tests/test_torch_slice.py's band for one cycle);
  no body reads to the host once its branch is captured.
* A new structure that uses only registered branches captures nothing, on
  the interpreter and through the generator; a lazily registered branch
  (a conjugate-gradient coarse solve) adds its own graph and bumps
  `isa_version` without recapturing the others; the prologue resets the
  program counter, so a program run again after another gives the same
  bits; `bytes_held()` stays flat over a second pass.
* `generate_and_evaluate` through the interpreter scores every tree as
  `cuda_graphs=False` does (ρ, iterations, power cycles, stage lengths),
  serially and from a pool of two threads; the Helmholtz outer solve
  through the split BiCGStab loop gives the eager solve's iterate, count
  and residual bit for bit.
* `vm_stats()` matches the JAX generator's key for key on the same trees
  and a tree that registers a branch lazily (the port adds only its probe
  state's two counters); a program past 320
  instructions is a pad overflow on both VMs.
"""

import contextlib
import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.backend.vm import CycleVM as JaxVM
from evostencils_tpu.ir import krylov as jax_krylov
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.utils.champions import apply_stored_omegas as jax_apply_stored_omegas
from evostencils_torch.backend import graphs
from evostencils_torch.backend.evaluation import PowerLoop, StageLoop, TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import PAD_CLASSES, CycleVM
from evostencils_torch.grammar import gp
from evostencils_torch.ir import krylov
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.parallel.dispatch import ThreadPoolDispatcher
from evostencils_torch.problems import helmholtz
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from torch_parity import JAX, PORT, Side, eager_capture, no_host_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")


@pytest.fixture(autouse=True)
def eager_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "capture", eager_capture)


def _tree_strings():
    side = Side(PORT, poisson_2d(min_level=2, max_level=6, dtype=torch.float32), depth=4)
    rng = random.Random(20260816)
    return [str(gp.gen_grow(side.pset, 2, 16, rng=rng)) for _ in range(16)]


TREES = _tree_strings()
N_BENCH = len(TREES) + 1  # and the champion


def _compile(side, index):
    """Bench tree `index` (16: the stored champion with its ω) on `side`."""
    if index < len(TREES):
        return side.compile(TREES[index])
    tree_string, omegas = parse_champion_file(CHAMPION)
    champion = side.compile(tree_string)
    apply = apply_stored_omegas if side.package is PORT else jax_apply_stored_omegas
    assert apply(champion, omegas, label="test champion")
    return champion


class Bench:
    """One dtype's problem, side, VM and interpreter, shared by the cases
    (the interpreter's graphs accumulate, as over an evolution)."""

    _made = {}

    @classmethod
    def of(cls, dtype):
        if dtype not in cls._made:
            cls._made[dtype] = cls(dtype)
        return cls._made[dtype]

    def __init__(self, dtype):
        self.dtype = dtype
        self.problem = poisson_2d(min_level=2, max_level=6, dtype=dtype)
        self.side = Side(PORT, self.problem, depth=4)
        self.vm = CycleVM(CycleLowering(dtype, "cpu"), self.problem, self.problem.max_level)
        self.interpreter = graphs.Interpreter(self.vm.make_state())
        self.expressions = [_compile(self.side, i) for i in range(N_BENCH)]

    def state(self, index):
        rng = np.random.default_rng(100 + index)
        shape = self.vm._shapes[0][0]
        return tuple((torch.from_numpy(rng.standard_normal(shape)).to(self.dtype),)
                     for _ in range(2))

    def interpret(self, program, u0, f, cycles=2, guard=None):
        """The finest iterate after `cycles` cycles of the interpreter, the
        cycles inside `guard` when one is given."""
        interpreter = self.interpreter
        with interpreter.lock:
            for d, x in zip(interpreter.u + interpreter.f, u0 + f):
                d.copy_(x)
            interpreter.load(program)
            with guard if guard is not None else contextlib.nullcontext():
                for _ in range(cycles):
                    interpreter.run_cycle()
            return tuple(x.clone() for x in interpreter.u)

    def eager(self, program, u0, f, cycles=2):
        step = self.vm.make_step()
        on_device = program._replace(omegas=torch.from_numpy(program.omegas))
        u = u0
        for _ in range(cycles):
            u = step(u, f, on_device)
        return u


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("index", range(N_BENCH))
def test_the_interpreter_runs_the_eager_step_bit_for_bit(dtype, index):
    bench = Bench.of(dtype)
    program = bench.vm.translate(bench.expressions[index])
    assert program is not None
    u0, f = bench.state(index)
    got = bench.interpret(program, u0, f)
    expected = bench.eager(program, u0, f)
    assert all(torch.equal(g, e) for g, e in zip(got, expected))
    # Once its branches are captured, no body reads to the host.
    again = bench.interpret(program, u0, f, guard=no_host_reads())
    assert all(torch.equal(g, e) for g, e in zip(again, expected))


@pytest.fixture(scope="module")
def jax_vm_step():
    jax_side = Side(JAX, jax_poisson_2d(min_level=2, max_level=6, dtype=jnp.float64), depth=4)
    jax_vm = JaxVM(JaxLowering(jnp.float64), jax_side.problem, 6)
    return jax_side, jax_vm, jax.jit(jax_vm.make_step())


@pytest.mark.parametrize("index", range(N_BENCH))
def test_the_interpreter_matches_the_reference_vm(jax_vm_step, index):
    """float64, one cycle: the reference's VM on its own translation of the
    same tree, the same opcodes on both sides."""
    jax_side, jax_vm, jax_step = jax_vm_step
    bench = Bench.of(torch.float64)
    program = bench.vm.translate(bench.expressions[index])
    jax_program = jax_vm.translate(_compile(jax_side, index))
    np.testing.assert_array_equal(program.opcodes, jax_program.opcodes[:program.length])
    u0, f = bench.state(index)
    got = bench.interpret(program, u0, f, cycles=1)[0].numpy()
    expected = np.asarray(jax_step((jnp.asarray(u0[0].numpy()),), (jnp.asarray(f[0].numpy()),),
                                   jax_program.as_arguments())[0])
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(got / scale, expected / scale, rtol=0, atol=1e-12)


def test_registered_branches_capture_nothing_and_the_prologue_resets_the_counter():
    """V(2,2) first; then V(1,2) and V(3,1) with other ω, new structures of
    the same branches, capture nothing; V(2,2) run again after them gives
    its first bits; a second pass holds the same bytes."""
    problem = poisson_2d(min_level=2, max_level=5, dtype=torch.float64)
    side = Side(PORT, problem)
    vm = CycleVM(CycleLowering(torch.float64, "cpu"), problem, problem.max_level)
    interpreter = graphs.Interpreter(vm.make_state())
    rng = np.random.default_rng(5)
    shape = vm._shapes[0][0]
    u0, f = ((torch.from_numpy(rng.standard_normal(shape)),) for _ in range(2))

    def run(expression):
        program = vm.translate(expression)
        for d, x in zip(interpreter.u + interpreter.f, u0 + f):
            d.copy_(x)
        interpreter.load(program)
        interpreter.run_cycle()
        return program, interpreter.u[0].clone()

    program, first = run(side.cycle(2, 2, 1.0))
    assert interpreter.captures == 1 + len(set(program.opcodes.tolist()))
    captured, held = interpreter.captures, graphs.bytes_held()
    for pre, post, omega in ((1, 2, 0.8), (3, 1, 1.1)):
        other, _ = run(side.cycle(pre, post, omega))
        assert not np.array_equal(other.opcodes, program.opcodes)
    assert interpreter.captures == captured
    program_again, again = run(side.cycle(2, 2, 1.0))
    assert torch.equal(again, first) and int(interpreter.state.pc) == program.length
    assert interpreter.captures == captured and graphs.bytes_held() == held


def test_a_lazy_branch_adds_its_graph_and_bumps_the_isa_version():
    """A conjugate-gradient coarse solve registers a CGS branch: one more
    graph, isa_version + 1, the earlier graphs kept; the result is the
    eager step's."""
    problem = poisson_2d(min_level=2, max_level=5, dtype=torch.float64)
    side = Side(PORT, problem)
    vm = CycleVM(CycleLowering(torch.float64, "cpu"), problem, problem.max_level)
    interpreter = graphs.Interpreter(vm.make_state())
    rng = np.random.default_rng(6)
    shape = vm._shapes[0][0]
    u0, f = ((torch.from_numpy(rng.standard_normal(shape)),) for _ in range(2))
    results = []
    for coarse_solver in (None, lambda A: krylov.generate_conjugate_gradient(A, 10)):
        version = vm.isa_version
        program = vm.translate(side.cycle(2, 2, 1.0, coarse_solver=coarse_solver))
        graphs_before = dict(interpreter._graphs)
        for d, x in zip(interpreter.u + interpreter.f, u0 + f):
            d.copy_(x)
        interpreter.load(program)
        interpreter.run_cycle()
        expected = vm.make_step()(u0, f, program)
        assert torch.equal(interpreter.u[0], expected[0])
        results.append((vm.isa_version - version, interpreter.captures))
        assert all(interpreter._graphs[k] is g for k, g in graphs_before.items())
    (bump_dense, captures_dense), (bump_cg, captures_cg) = results
    assert bump_dense == 0 and bump_cg == 1 and captures_cg == captures_dense + 1


def _generators(problem, dtype, **kwargs):
    cached = TorchProgramGenerator(problem, dtype=dtype, device="cpu", **kwargs)
    cached.graph_cache = graphs.GraphCache()
    eager = TorchProgramGenerator(problem, dtype=dtype, device="cpu", **kwargs)
    return cached, eager


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generate_and_evaluate_on_the_interpreter_is_the_eager_fitness(dtype):
    """Every bench tree and the champion: ρ, iterations, power cycles and
    stage lengths equal; the VM path's captures stay within the branches
    registered and the glue, and a second pass captures nothing."""
    bench = Bench.of(dtype)
    cached, eager = _generators(bench.problem, dtype, iteration_limit=100)
    for expr in bench.expressions:
        got = cached.generate_and_evaluate(expr, evaluation_samples=1)
        expected = eager.generate_and_evaluate(expr, evaluation_samples=1)
        assert got[1:] == expected[1:]
        assert cached.last_cycle_solve == eager.last_cycle_solve
    stats = cached.graph_stats()
    assert stats["structures"] == N_BENCH and stats["lowered_captures"] == 0
    assert stats["vm_captures"] <= stats["branches_registered"] + stats["glue_bodies"]
    # The stage loop's glue, and the power loop's in float32.
    loops = 1 if dtype == torch.float64 else 2
    assert len(cached.graph_cache) == loops and cached.vm_stats()["vm_hits"] == N_BENCH
    held = graphs.bytes_held()
    for expr in bench.expressions[:4]:
        cached.generate_and_evaluate(expr, evaluation_samples=1)
    assert cached.graph_stats() == stats and graphs.bytes_held() == held


def test_a_pool_of_two_threads_shares_one_interpreter():
    """Eight bench trees from two threads through one interpreter (its lock
    serialises them): the serial eager fitnesses."""
    bench = Bench.of(torch.float32)
    cached, eager = _generators(bench.problem, torch.float32, iteration_limit=100)
    expressions = bench.expressions[:8]
    expected = [eager.generate_and_evaluate(e, evaluation_samples=1)[1:] for e in expressions]
    got = ThreadPoolDispatcher(2).map(
        lambda e: cached.generate_and_evaluate(e, evaluation_samples=1)[1:], expressions)
    assert got == expected and len(cached._interpreters) == 1


@pytest.mark.parametrize("kind", ["collective", (2, 2)])
def test_the_outer_solve_through_the_split_bicgstab_is_the_eager_one(kind):
    """Helmholtz k = 20, levels 3-5, complex128, V(2,1) ω 0.6 as the
    preconditioner: through the interpreter (point smoother) or a lowered
    structure's own cycle (block smoother, outside the slim ISA), 60 outer
    iterations at most: the iterate, the count and the residual equal the
    eager solve's to the bit; no glue body reads to the host."""
    problem = helmholtz.helmholtz_2d(3, 5, k=20.0, dtype=torch.complex128)
    expr = Side(PORT, problem).cycle(2, 1, 0.6, kind=kind)
    cached, eager = _generators(problem, torch.complex128)
    f = cached._to_device(problem.initial_state(torch.complex128)[1])
    results = []
    for generator in (cached, eager):
        (solve, _), omega_arg = generator._build_outer_solver(expr, probe_iterations=60)
        results.append(solve(f, omega_arg))
    (x, res, res0, it), (x_ref, res_ref, res0_ref, it_ref) = results
    assert (it, res, res0) == (it_ref, res_ref, res0_ref) and it > 0
    assert all(torch.equal(a, b) for a, b in zip(x, x_ref))
    assert (len(cached._interpreters) == 1) == (kind == "collective")
    loop = next(iter(cached.graph_cache._entries.values()))
    with no_host_reads():
        for name in loop.bodies:
            loop.run(name)
        loop.iteration()


def test_no_host_read_in_the_glue_on_the_interpreter():
    """The stage and power glue around the interpreter, after a warm run."""
    bench = Bench.of(torch.float32)
    program = bench.vm.translate(bench.expressions[-1])
    operator = bench.side.terminals[0].operator
    lowering = bench.vm.lowering

    def residual_norm(u, rhs):
        return sops.l2_norm(sops.tree_sub(rhs, lowering.system_apply(operator, u)))

    u0, f = bench.state(0)
    interpreter = bench.interpreter
    with interpreter.lock:
        stage, power = StageLoop(interpreter, residual_norm), PowerLoop(interpreter, sops.l2_norm)
        stage.load(u0, f, program)
        stage.capture_bodies()
        power.capture_bodies()
        stage.run("start")
        stage.step()
        power.load(u0, f, program)
        power.block()
        with no_host_reads():
            stage.run("start")
            stage.step()
            power.block()
    assert int(stage.it) == 1 and math.isfinite(float(power.rate))


def test_vm_stats_match_the_reference_generator():
    """The 16 trees, then a V(2,2) whose coarse solve is 10 CG iterations
    (a CGS branch registered lazily: one ISA recompile), then two trees
    again: the same counts on both generators, key for key."""
    port_side = Side(PORT, poisson_2d(min_level=2, max_level=6, dtype=torch.float32), depth=4)
    jax_side = Side(JAX, jax_poisson_2d(min_level=2, max_level=6, dtype=jnp.float32), depth=4)
    port = TorchProgramGenerator(port_side.problem, dtype=torch.float32, device="cpu")
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float32)
    order = list(range(len(TREES))) + ["cg", 0, 5]
    for item in order:
        for side, generator, cg in ((port_side, port, krylov.generate_conjugate_gradient),
                                    (jax_side, reference, jax_krylov.generate_conjugate_gradient)):
            if item == "cg":
                expr = side.cycle(2, 2, 1.0, coarse_solver=lambda A: cg(A, 10))
            else:
                expr = side.compile(TREES[item])
            generator._build_solver(expr)
        stats = port.vm_stats()
        assert {k: stats[k] for k in reference.vm_stats()} == reference.vm_stats(), item
        # The port's own keys: the probe state's cache (no evaluation here).
        assert set(stats) - set(reference.vm_stats()) == {"probe_state_hits",
                                                          "probe_state_builds"}
    assert port.vm_stats()["vm_isa_recompiles"] == 1
    assert port.vm_stats()["vm_hits"] == len(order)


def test_a_program_past_320_instructions_is_a_pad_overflow():
    """A chain of smoothing steps at the finest level: 320 translate on
    both VMs, 321 overflow on both; the generator counts the miss and the
    overflow and lowers the chain from the IR."""

    def chain(side, steps):
        b, terminals = side.package.base, side.terminals[0]
        A, u, f = terminals.operator, terminals.approximation, side.problem.rhs()
        smoother = side.smoother_factory("collective")(A)
        for _ in range(steps):
            u = b.Cycle(u, f, b.Multiplication(b.Inverse(smoother), b.Residual(A, u, f)),
                        partitioning=side.package.part.RedBlack, relaxation_factor=0.9)
        return u

    port_side = Side(PORT, poisson_2d(min_level=2, max_level=4, dtype=torch.float32))
    jax_side = Side(JAX, jax_poisson_2d(min_level=2, max_level=4, dtype=jnp.float32))
    vm = CycleVM(CycleLowering(torch.float32, "cpu"), port_side.problem, 4)
    jax_vm = JaxVM(JaxLowering(jnp.float32), jax_side.problem, 4)
    for steps, verdict in ((PAD_CLASSES[-1], None), (PAD_CLASSES[-1] + 1, "pad_overflow")):
        program, jax_program = vm.translate(chain(port_side, steps)), jax_vm.translate(
            chain(jax_side, steps))
        assert (program is None) == (jax_program is None) == (verdict is not None)
        assert vm.last_failure == jax_vm.last_failure == verdict
        if program is not None:
            assert program.length == jax_program.length == steps
    port = TorchProgramGenerator(port_side.problem, dtype=torch.float32, device="cpu")
    _, omega_arg = port._build_solver(chain(port_side, PAD_CLASSES[-1] + 1))
    assert len(omega_arg) == PAD_CLASSES[-1] + 1
    assert port.vm_stats() == {"vm_hits": 0, "vm_misses": 1, "vm_pad_overflows": 1,
                               "vm_isa_recompiles": 0, "vm_hit_rate": 0.0,
                               "probe_state_hits": 0, "probe_state_builds": 0}
