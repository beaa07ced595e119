"""The port's staged deep solves (backend/device_solve.py) against the JAX
package's on the CPU.

Both sides build 2D Poisson on levels 3-6 (63² finest) and the textbook
V-cycles through their own package's grammar and reference cycles, take ρ
from their own generator (float32 power iteration), and run the same
builder: float32 cycles, float64 restart residuals (JAX's float64 is IEEE
float64 on the CPU, as the port's), the verdict from the exact host
float64 residual.  Tolerances:
  * every solve reaches rel ≤ 1e-10 on both sides;
  * the predicted solve: cycles within ±2 and stages within ±1 of the
    reference (the float32 cycles sum in another order, and the
    self-tuning stage length follows the measured reductions);
  * the reference's two properties hold on the port (tests/test_backend.py
    TestPredictedStagedSolver): V(2,2) needs fewer cycles than V(1,1), and
    floor calibration needs no more stages and at most 3 more cycles;
  * the floor probe's floor within 2× of the reference's (a float32 stall
    level, set by rounding);
  * the reactive and the fused solver reach the target on both sides,
    cycles within ±3 and stages within ±1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend import device_solve as jax_device_solve
from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.ir import reference_cycles as jax_reference_cycles
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch.backend import device_solve
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir import reference_cycles
from evostencils_torch.problems.poisson import poisson_2d
from tests.torch_parity import JAX, PORT, Side

MIN_LEVEL, MAX_LEVEL = 3, 6
TARGET = 1e-10


class Solver:
    """One package's problem, generator, lowerings and textbook cycles."""

    def __init__(self, package):
        self.jax = package is JAX
        if self.jax:
            problem = jax_poisson_2d(min_level=MIN_LEVEL, max_level=MAX_LEVEL, dtype=jnp.float32)
            self.generator = JaxProgramGenerator(problem, dtype=jnp.float32)
            self.lowering32 = JaxLowering(jnp.float32, use_pallas=False)
            self.lowering64 = JaxLowering(jnp.float64, use_pallas=False)
            self.module, self.cycles = jax_device_solve, jax_reference_cycles
        else:
            problem = poisson_2d(min_level=MIN_LEVEL, max_level=MAX_LEVEL, dtype=torch.float32)
            self.generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
            self.lowering32 = CycleLowering(torch.float32, "cpu")
            self.lowering64 = CycleLowering(torch.float64, "cpu", use_kernels=False)
            self.module, self.cycles = device_solve, reference_cycles
        self.side = Side(package, problem)
        self.problem = problem
        dtype = jnp.float32 if self.jax else torch.float32
        _, f32 = problem.initial_state(dtype)
        self.f32_rhs = tuple(jnp.asarray(x) for x in f32) if self.jax else tuple(
            torch.from_numpy(np.asarray(x)) for x in f32)

    def v_cycle(self, pre, post, omega=1.0):
        return self.cycles.generate_v_cycle(
            self.side.terminals, self.problem.rhs(), pre, post, omega=omega)

    def rho(self, expression):
        _, rho, _ = self.generator.generate_and_evaluate(expression, evaluation_samples=1)
        return float(rho)

    def solver(self, expression, **kwargs):
        return self.module.staged_solver_for_expression(
            self.lowering32, expression, self.side.terminals[0].operator, self.problem,
            self.generator, target=TARGET, lowering64=self.lowering64, **kwargs)

    def solve(self, expression, **kwargs):
        solve, f64_rhs = self.solver(expression, **kwargs)
        return solve(self.f32_rhs, f64_rhs), solve


@pytest.fixture(scope="module")
def sides():
    return Solver(JAX), Solver(PORT)


def test_predicted_solver_matches_reference_and_tracks_rho(sides):
    outcomes = {}
    for side in sides:
        results = {}
        for name, pre, post, omega in (("v11", 1, 1, 0.8), ("v22", 2, 2, 1.0)):
            expression = side.v_cycle(pre, post, omega)
            rho = side.rho(expression)
            assert 0 < rho < 1
            (cycles, rel, stages), _ = side.solve(expression, rho=rho)
            assert rel <= TARGET, (side.jax, name, rel)
            assert stages >= 2
            results[name] = (cycles, stages, rho)
        # The much-better-ρ V(2,2) must use fewer cycles than V(1,1).
        assert results["v22"][2] < results["v11"][2]
        assert results["v22"][0] < results["v11"][0]
        outcomes[side.jax] = results
    for name in ("v11", "v22"):
        (jc, js, jr), (tc, ts, tr) = outcomes[True][name], outcomes[False][name]
        assert abs(tc - jc) <= 2 and abs(ts - js) <= 1, (name, outcomes)
        assert abs(tr - jr) <= 0.01 * jr


def test_floor_calibration_reduces_stages_as_in_reference(sides):
    floors = {}
    for side in sides:
        expression = side.v_cycle(2, 2)
        rho = side.rho(expression)
        outcomes = {}
        for calibrate in (False, True):
            (cycles, rel, stages), solve = side.solve(
                expression, rho=rho, calibrate_floor=calibrate)
            assert rel <= TARGET
            outcomes[calibrate] = (stages, cycles)
            if calibrate:
                assert solve.measured_floor is not None
                assert 0 < solve.measured_floor < 5e-3
                floors[side.jax] = solve.measured_floor
        assert outcomes[True][0] <= outcomes[False][0]
        assert outcomes[True][1] <= outcomes[False][1] + 3
    assert 0.5 <= floors[False] / floors[True] <= 2.0, floors


def test_floor_probe_within_twice_the_reference(sides):
    floors = {}
    for side in sides:
        expression = side.v_cycle(2, 1)
        step = side.lowering32.lower(expression)
        operator = side.side.terminals[0].operator
        shapes = tuple(np.asarray(x).shape for x in side.f32_rhs)
        if side.jax:
            probe = jax_device_solve.build_floor_probe(
                step, lambda u: side.lowering32.system_apply(operator, u), shapes)
            k, floor = probe(side.f32_rhs)
        else:
            probe = device_solve.build_floor_probe(
                step, lambda u: side.lowering32.system_apply(operator, u), shapes, device="cpu")
            k, floor = probe(side.f32_rhs)
        floors[side.jax] = (int(k), float(floor))
        assert 0 < float(floor) < 5e-3 and int(k) >= 2
    assert 0.5 <= floors[False][1] / floors[True][1] <= 2.0, floors


@pytest.mark.parametrize("fused", [False, True])
def test_reactive_and_fused_solvers_reach_target(sides, fused):
    outcomes = {}
    for side in sides:
        (cycles, rel, stages), _ = side.solve(side.v_cycle(2, 1), fused=fused)
        assert rel <= TARGET, (side.jax, fused, rel)
        outcomes[side.jax] = (cycles, stages)
    (jc, js), (tc, ts) = outcomes[True], outcomes[False]
    assert abs(tc - jc) <= 3 and abs(ts - js) <= 1, outcomes


class _Judged:
    """The port's generator as a staged solver sees it, keeping the iterate
    and the right-hand side of the last verdict."""

    def __init__(self, generator):
        self.generator = generator
        self.last = None

    def _host_residual(self, operator, u_fields, f_fields):
        self.last = (u_fields, f_fields)
        return self.generator._host_residual(operator, u_fields, f_fields)


@pytest.mark.parametrize("mode", ["reactive", "fused", "predicted"])
def test_one_solver_judges_each_right_hand_side_against_itself(sides, mode):
    """One solver, two right-hand sides in turn: each solve's verdict reads
    the float64 right-hand side that solve was given, and its final iterate
    meets the target against it in float64."""
    port = sides[1]
    expression = port.v_cycle(2, 2)
    kwargs = {"reactive": {}, "fused": {"fused": True},
              "predicted": {"rho": port.rho(expression)}}[mode]
    judged = _Judged(port.generator)
    operator = port.side.terminals[0].operator
    solve, f64_rhs = device_solve.staged_solver_for_expression(
        port.lowering32, expression, operator, port.problem, judged, target=TARGET,
        lowering64=port.lowering64, **kwargs)
    rng = np.random.default_rng(11)
    other = tuple(rng.standard_normal(np.shape(x)).astype(np.float32).astype(np.float64)
                  for x in f64_rhs)
    for f64 in (f64_rhs, other, f64_rhs):
        f32 = tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in f64)
        _, rel, _ = solve(f32, f64)
        u, judged_f = judged.last
        assert all(np.array_equal(a, b) for a, b in zip(judged_f, f64))
        r = port.generator._host_residual(operator, u, f64)
        true_rel = (np.sqrt(sum(np.sum(x ** 2) for x in r))
                    / np.sqrt(sum(np.sum(np.asarray(x) ** 2) for x in f64)))
        assert true_rel <= TARGET and rel == pytest.approx(true_rel, rel=1e-12), (mode, rel)


def test_stored_omegas_take_the_parameterized_lowering():
    """An ω vector goes through `lower_parameterized` as one float32 device
    tensor; with the cycle's own factors it solves as the plain lowering."""
    side = Solver(PORT)
    expression = side.v_cycle(2, 2)
    omegas = side.lowering32.lower_parameterized(expression)[1]
    plain, _ = side.solve(expression)
    parameterized, _ = side.solve(expression, omegas=omegas)
    assert plain == parameterized and plain[1] <= TARGET


def test_next_stage_length_is_the_reference_formula():
    """k_next in host float64 against the reference's formula evaluated by
    JAX in float64, over reductions from a fast to a stalling stage."""
    log_floor, inner_cap = np.log(5e-3), 40
    next_k = device_solve._next_stage_length(log_floor, TARGET, inner_cap)
    for rel, new_rel, k in ((1.0, 2e-3, 4), (3e-3, 1e-5, 5), (1e-5, 9.9e-6, 7),
                            (2e-8, 1e-11, 3), (1e-9, 5e-10, 40), (1.0, 1e-13, 2)):
        achieved = jnp.clip(jnp.float64(new_rel) / rel, 1e-12, 0.97)
        r_eff = jnp.log(achieved) / jnp.float64(k)
        k_remaining = jnp.ceil(jnp.log(jnp.clip(TARGET / jnp.float64(new_rel), 1e-300, 1.0))
                               / r_eff)
        expected = jnp.clip(
            jnp.minimum(jnp.ceil(jnp.float64(log_floor) / r_eff), k_remaining)
            .astype(jnp.int32) + 1, 2, inner_cap)
        assert next_k(rel, new_rel, k) == int(expected), (rel, new_rel, k)


def test_cycle_timing_on_cpu_tensors_is_host_time():
    """On CPU tensors per_cycle_time differences host-clock loops of K and 3K
    eager cycles; wall_cycle_time is the eager cycle's host time."""
    from evostencils_torch.utils.timing import per_cycle_time, wall_cycle_time

    side = Solver(PORT)
    step = side.lowering32.lower(side.v_cycle(2, 1))
    u0, f = side.problem.initial_state(torch.float32, device="cpu")
    calls = []

    def counted(u, f):
        calls.append(1)
        return step(u, f)

    assert per_cycle_time(counted, u0, f, iters=2, repeats=2) > 0
    assert len(calls) == 1 + 2 * (2 + 6)  # one warm-up, then K and 3K per repeat
    assert wall_cycle_time(step, u0, f, iters=2, repeats=2) > 0

