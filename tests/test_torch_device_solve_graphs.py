"""The staged deep solves' bodies (backend/device_solve.StagedLoop), which
a card captures in CUDA graphs, on the CPU.

A CPU has no graphs, so these tests hold what a capture relies on:

* nothing inside a body reads a value to the host or makes a tensor from
  host data, after a warm-up call: the guard of tests/torch_parity.py
  around one call of the cycle, `start`, `post`, `begin` and `restart`
  (2D Poisson, levels 2-6, float32; textbook V(2,1) and V(2,2) through
  `CycleLowering.lower`, the stored tuned champion through
  `lower_parameterized` with its ω as a float32 tensor);
* with `graphs.capture` replaced by the eager stand-in
  (`torch_parity.eager_capture`), every builder (reactive, fused, floor
  probe, predicted with and without floor calibration) gives the cycles,
  stages and relative residual of the port's earlier eager builders
  exactly (copied here as the oracle), and so does `cuda_graphs=False`;
* the builders on the stand-in stay within tests/test_torch_device_solve.py's
  bands of the JAX package at 63² (levels 3-6): predicted cycles ±2 and
  stages ±1, reactive and fused cycles ±3 and stages ±1, the probe's floor
  within 2×;
* `cuda_graphs` follows TorchProgramGenerator's rules.
"""

import math
import os

import numpy as np
import pytest
import torch

from evostencils_torch.backend import device_solve, graphs
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.ir import reference_cycles
from evostencils_torch.ops.stencil_ops import l2_norm, numpy_l2_norm
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
import test_torch_device_solve
from torch_parity import PORT, Side, eager_graphs, no_host_reads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")
TARGET = 1e-10


# ---- the earlier eager builders, the oracle ------------------------------

def _parent_stage_loop(step, apply_a32, shapes, inner_cap, stall_ratio, stage_reduction=None):
    """evostencils_torch/backend/device_solve.py's `_stage_loop` before its
    bodies moved onto static buffers."""
    f32 = np.float32

    def run(fs, rs0):
        e = tuple(torch.zeros(s, dtype=torch.float32) for s in shapes)
        k, rn, prev = 0, f32(rs0), f32(np.inf)
        while True:
            improving = k < 2 or rn < f32(stall_ratio) * prev
            keep = k < inner_cap and bool(np.isfinite(rn)) and improving
            if stage_reduction is not None:
                keep = keep and rn > f32(stage_reduction) * f32(rs0)
            if not keep:
                return e, k, rn, prev
            e = step(e, fs)
            new_rn = f32(l2_norm(tuple(f - a for f, a in zip(fs, apply_a32(e)))).item())
            k, rn, prev = k + 1, new_rn, rn

    return run


def _f32(host_state):
    return tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in host_state)


def _host64(state):
    return tuple(x.numpy().astype(np.float64) for x in state)


def _parent_solver(step, apply_a32, apply_a64, host_residual, shapes, f64_rhs, mode, rho=None,
                   calibrate_floor=False):
    """The earlier eager solvers of `mode` ("reactive", "fused",
    "predicted"), wired as `staged_solver_for_expression` wired them:
    solve() -> (cycles, rel, stages); and the probe's floor when calibrated."""

    def polish(u_host, r_true, r0, rel, cycles, stages, run_k, stage_cap):
        while rel > TARGET and stages < stage_cap and cycles < 1000:
            e, kk = run_k(_f32(r_true))
            if kk == 0:
                break
            u_host = tuple(u + x for u, x in zip(u_host, _host64(e)))
            r_true = host_residual(u_host)
            cycles += kk
            stages += 1
            new_rel = numpy_l2_norm(r_true) / r0
            if new_rel >= rel:
                break
            rel = new_rel
        return cycles, rel, stages

    if mode == "reactive":
        run = _parent_stage_loop(step, apply_a32, shapes, 100, 0.9, 1e-5)

        def solve():
            stage = lambda fs: run(fs, np.float32(l2_norm(fs).item()))[:2]  # noqa: E731
            return polish(tuple(np.zeros(s) for s in shapes), f64_rhs, numpy_l2_norm(f64_rhs), 1.0,
                          0, 0, stage, 10)
        return solve, None

    floor = None
    if mode == "fused":
        run = _parent_stage_loop(step, apply_a32, shapes, 60, 0.9, 1e-5)

        def inner(fs, _k):
            e, k, _, _ = run(fs, np.float32(l2_norm(fs).item()))
            return e, k
        k0, next_k, max_stages, polish_cap = None, None, 8, 8
        polish_stage = lambda fs: inner(fs, None)  # noqa: E731
    else:
        floor_estimate = 5e-3
        if calibrate_floor:
            probe = _parent_stage_loop(step, apply_a32, shapes, 60, 0.95)
            fs0 = _f32(f64_rhs)
            rs0 = np.float32(l2_norm(fs0).item())
            _, _, rn, prev = probe(fs0, rs0)
            floor = float(min(rn, prev) / rs0)
            floor_estimate = min(2.0 * floor, 5e-3)
        rho = float(min(max(rho, 1e-6), 0.95))
        k_stage = int(np.clip(np.ceil(np.log(floor_estimate) / np.log(rho)) + 1, 2, 40))
        next_k = device_solve._next_stage_length(math.log(floor_estimate), TARGET, 40)

        def inner(fs, k):
            e = tuple(torch.zeros(s, dtype=torch.float32) for s in shapes)
            for _ in range(k):
                e = step(e, fs)
            return e, k
        k0, max_stages, polish_cap = k_stage, 12, 16
        polish_stage = lambda fs: inner(fs, k_stage)  # noqa: E731

    def solve():
        f64_dev = tuple(torch.from_numpy(np.asarray(x, np.float64)) for x in f64_rhs)
        r0 = l2_norm(f64_dev).item()
        u64 = tuple(torch.zeros(s, dtype=torch.float64) for s in shapes)
        r64 = f64_dev
        cycles, stages, k, prev_rel = 0, 0, k0, math.inf
        rel = l2_norm(r64).item() / r0
        while rel > TARGET and rel < prev_rel and stages < max_stages and cycles < 500:
            e, executed = inner(tuple(x.to(torch.float32) for x in r64), k)
            u64 = tuple(u + x.to(torch.float64) for u, x in zip(u64, e))
            r64 = tuple(f - a for f, a in zip(f64_dev, apply_a64(u64)))
            new_rel = l2_norm(r64).item() / r0
            if next_k is not None:
                k = next_k(rel, new_rel, executed)
            cycles += executed
            stages += 1
            prev_rel, rel = rel, new_rel
        u_host = _host64(u64)
        r_true = host_residual(u_host)
        r0_host = numpy_l2_norm(f64_rhs)
        return polish(u_host, r_true, r0_host, numpy_l2_norm(r_true) / r0_host, cycles, stages,
                      polish_stage, polish_cap)

    return solve, floor


# ---- the problem, its cycles and their pieces ----------------------------

class Case:
    """2D Poisson at `levels` in float32: a cycle's step (the plain
    lowering, or the ω-parameterized one with ω as a float32 tensor), the
    operators and the host residual, as staged_solver_for_expression wires
    them."""

    def __init__(self, name, levels=(2, 6)):
        self.problem = poisson_2d(*levels, dtype=torch.float32)
        side = Side(PORT, self.problem, depth=4 if name == "champion" else None)
        self.lowering32 = CycleLowering(torch.float32, "cpu")
        self.lowering64 = CycleLowering(torch.float64, "cpu", use_kernels=False)
        self.operator = side.terminals[0].operator
        self.generator = TorchProgramGenerator(self.problem, dtype=torch.float32, device="cpu")
        self.omegas = None
        if name == "champion":
            tree_string, omegas = parse_champion_file(CHAMPION)
            self.expression = side.compile(tree_string)
            assert apply_stored_omegas(self.expression, omegas, label="test champion")
            pstep, self.omegas = self.lowering32.lower_parameterized(self.expression)
            om = torch.tensor(self.omegas, dtype=torch.float32)
            self.step = lambda u, f: pstep(u, f, om)
        else:
            pre, post = {"v21": (2, 1), "v22": (2, 2)}[name]
            self.expression = reference_cycles.generate_v_cycle(
                side.terminals, self.problem.rhs(), pre, post)
            self.step = self.lowering32.lower(self.expression)
        u0, f0 = self.problem.initial_state(torch.float32)
        self.shapes = tuple(x.shape for x in u0)
        self.f64_rhs = tuple(np.asarray(x, np.float64) for x in f0)

    def apply_a32(self, u):
        return self.lowering32.system_apply(self.operator, u)

    def apply_a64(self, u):
        return self.lowering64.system_apply(self.operator, u)

    def host_residual(self, u64, f64=None):
        """f − A·u in host float64; f is the case's right-hand side unless
        given (the solvers pass the one each solve was given)."""
        f64 = self.f64_rhs if f64 is None else f64
        return tuple(self.generator._host_residual(self.operator, u64, f64))

    def loop(self):
        return device_solve.StagedLoop(self.step, self.apply_a32, self.shapes, "cpu",
                                       self.apply_a64)

    def rho(self):
        return float(self.generator.generate_and_evaluate(
            self.expression, evaluation_samples=1)[1])

    def solver(self, **kwargs):
        solve, f64_rhs = device_solve.staged_solver_for_expression(
            self.lowering32, self.expression, self.operator, self.problem, self.generator,
            omegas=self.omegas, lowering64=self.lowering64, target=TARGET, **kwargs)
        return solve, lambda: solve(None, f64_rhs)

    def parent(self, mode, **kwargs):
        return _parent_solver(self.step, self.apply_a32, self.apply_a64, self.host_residual,
                              self.shapes, self.f64_rhs, mode, **kwargs)


CASES = ("v21", "v22", "champion")


@pytest.mark.parametrize("name", CASES)
def test_no_host_read_inside_the_staged_bodies(name):
    """One call of every body after a warm-up call; then the host loops
    around them read only the norms."""
    case = Case(name)
    loop = case.loop()
    rng = np.random.default_rng(7)
    device_solve._copy_host(loop.f64, (rng.standard_normal(s) for s in case.shapes))
    calls = (loop.begin, loop.start, loop.cycle.cycle, loop.post, loop.restart)
    for body in calls:
        body()
    with no_host_reads():
        for body in calls:
            body()
    assert math.isfinite(float(loop.rn)) and math.isfinite(float(loop.rn64))
    assert loop.bodies == ("start", "post", "begin", "restart")


def _captured(loop):
    """The loop's bodies and cycle "captured" by the eager stand-in."""
    before = graphs.counters.captures
    loop.capture_bodies(warmup=device_solve.CAPTURE_WARMUP)
    assert loop._graphs is not None and loop.cycle._graphs is not None
    assert loop.captures == graphs.counters.captures - before == len(loop.bodies) + 1
    return loop


@pytest.mark.parametrize("name", CASES)
def test_builders_on_graphs_give_the_earlier_eager_results_exactly(name, eager_graphs):
    """Every builder on a loop captured by the stand-in, and through
    staged_solver_for_expression eagerly, against the oracle: cycles,
    stages and rel to the bit, the probe's floor too."""
    case = Case(name)
    rho = case.rho()
    assert 0 < rho < 1
    builders = {
        "reactive": lambda loop: device_solve.build_staged_solver(
            case.step, case.apply_a32, case.host_residual, case.shapes, target=TARGET,
            device="cpu", loop=loop)[0],
        "fused": lambda loop: device_solve.build_fused_staged_solver(
            case.step, case.apply_a32, case.apply_a64, case.host_residual, case.shapes,
            target=TARGET, device="cpu", loop=loop),
        "predicted": lambda loop: device_solve.build_predicted_staged_solver(
            case.step, case.apply_a32, case.apply_a64, case.host_residual, case.shapes,
            rho=rho, target=TARGET, device="cpu", loop=loop),
    }
    for mode, build in builders.items():
        expected, _ = case.parent(mode, rho=rho)
        expected = expected()
        assert expected[1] <= TARGET, (mode, expected)
        loop = _captured(case.loop())
        solve = build(loop)
        assert solve(None, case.f64_rhs) == expected, mode
        # A second solve on the same graphs starts afresh.
        assert solve(None, case.f64_rhs) == expected, mode
        kwargs = {"fused": True} if mode == "fused" else (
            {"rho": rho} if mode == "predicted" else {})
        solve, run = case.solver(cuda_graphs=False, **kwargs)
        assert run() == expected and solve.graphs["captures"] == 0, mode

    expected, floor = case.parent("predicted", rho=rho, calibrate_floor=True)
    expected = expected()
    solve, run = case.solver(rho=rho, calibrate_floor=True)
    assert run() == expected and solve.measured_floor == floor
    loop = _captured(case.loop())
    probe = device_solve.build_floor_probe(case.step, case.apply_a32, case.shapes,
                                           device="cpu", loop=loop)
    k, got = probe(_f32(case.f64_rhs))
    assert float(got) == floor and k >= 2


@pytest.fixture(scope="module")
def references():
    """The JAX package's solvers at 63²: V(2,1) reactive and fused,
    V(2,2) predicted with and without calibration, the V(2,1) probe."""
    side = test_torch_device_solve.Solver(test_torch_device_solve.JAX)
    out = {}
    v21, v22 = side.v_cycle(2, 1), side.v_cycle(2, 2)
    for mode in ("reactive", "fused"):
        out[mode] = side.solve(v21, fused=mode == "fused")[0]
    rho = side.rho(v22)
    for calibrate in (False, True):
        (cycles, rel, stages), solve = side.solve(v22, rho=rho, calibrate_floor=calibrate)
        out[("predicted", calibrate)] = (cycles, rel, stages)
        if calibrate:
            out["floor"] = float(solve.measured_floor)
    return out


@pytest.mark.parametrize("mode", ["reactive", "fused", "predicted", "calibrated"])
def test_builders_on_graphs_stay_within_the_reference_bands(mode, references, eager_graphs):
    case = Case("v21" if mode in ("reactive", "fused") else "v22", levels=(3, 6))
    loop = _captured(case.loop())
    if mode == "reactive":
        solve = device_solve.build_staged_solver(
            case.step, case.apply_a32, case.host_residual, case.shapes, target=TARGET,
            device="cpu", loop=loop)[0]
        expected, band = references["reactive"], 3
    elif mode == "fused":
        solve = device_solve.build_fused_staged_solver(
            case.step, case.apply_a32, case.apply_a64, case.host_residual, case.shapes,
            target=TARGET, device="cpu", loop=loop)
        expected, band = references["fused"], 3
    else:
        rho, floor_estimate = case.rho(), 5e-3
        if mode == "calibrated":
            probe = device_solve.build_floor_probe(case.step, case.apply_a32, case.shapes,
                                                   device="cpu", loop=loop)
            _, floor = probe(_f32(case.f64_rhs))
            assert 0.5 <= float(floor) / references["floor"] <= 2.0
            floor_estimate = min(2.0 * float(floor), 5e-3)
        solve = device_solve.build_predicted_staged_solver(
            case.step, case.apply_a32, case.apply_a64, case.host_residual, case.shapes,
            rho=rho, target=TARGET, floor_estimate=floor_estimate, device="cpu", loop=loop)
        expected, band = references[("predicted", mode == "calibrated")], 2
    cycles, rel, stages = solve(None, case.f64_rhs)
    assert rel <= TARGET and expected[1] <= TARGET
    assert abs(cycles - expected[0]) <= band and abs(stages - expected[2]) <= 1, (
        (cycles, rel, stages), expected)


def test_cuda_graphs_flag_rules_of_the_staged_solvers():
    """Eager on the CPU by default; True off a card raises ValueError."""
    case = Case("v21", levels=(2, 5))
    solve, run = case.solver()
    assert solve.graphs == {"captures": 0, "capture_s": 0.0, "bytes": 0}
    assert run()[1] <= TARGET
    with pytest.raises(ValueError, match="no CUDA graphs"):
        case.solver(cuda_graphs=True)
