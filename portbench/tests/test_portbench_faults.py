"""Whole runs of each cell on the CPU at a small size (the harness's look
for a card skipped), once as they are and once with the timed path broken
underneath, where the check must read `correct` false.  The faults a cell
can have: a cycle that returns its state unchanged, and an answer altered
where the program produces it.  No cell batches members or spans chips, so
the faults of a half batch and of a missing exchange do not arise."""

import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from evostencils_torch.backend import device_solve, evaluation, graphs
from evostencils_torch.ops import krylov
from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {
    "poisson2d_511.search": {"config": {"min_level": 2, "max_level": 6},
                             "traffic": {"order": [0, 3, 9, 31], "check_trees": 4}},
    "poisson2d_511.solve": {"config": {"min_level": 2, "max_level": 6},
                            "traffic": {"warmup_solves": 3}},
    "helmholtz2d_127.outer": {"config": {"min_level": 1, "max_level": 5, "k": 20.0},
                              "traffic": {"order": [0, 9], "warmup": [0]}},
}


def run(workload, seconds=1.0):
    return harness.run(ROOT, workload, 2 ** 31 + 7, seconds, False, time.monotonic(),
                       device="cpu", overrides=SMALL[workload])


def unchanged_state(monkeypatch):
    monkeypatch.setattr(graphs.StepCycle, "run_cycle", lambda self: None)


def altered_rate(monkeypatch):
    block_rate = evaluation.PowerLoop.block_rate

    def altered(self):
        block_rate(self)
        self.rate.mul_(1.01)

    monkeypatch.setattr(evaluation.PowerLoop, "block_rate", altered)


def altered_verdict(monkeypatch):
    """The staged solve's residuals, on the device after each restart and on
    the host, read a thousand times too small: the solver stops early."""
    restart = device_solve.StagedLoop.restart
    host_residual = evaluation.TorchProgramGenerator._host_residual

    def altered_restart(self):
        restart(self)
        self.rn64.mul_(1e-3)

    def altered_host(self, operator, u_fields, f_fields):
        return [1e-3 * r for r in host_residual(self, operator, u_fields, f_fields)]

    monkeypatch.setattr(device_solve.StagedLoop, "restart", altered_restart)
    monkeypatch.setattr(evaluation.TorchProgramGenerator, "_host_residual", altered_host)


def altered_count(monkeypatch):
    solve = krylov.BicgstabLoop.solve

    def altered(self, rhs, max_iterations, target_reduction):
        x, it, res = solve(self, rhs, max_iterations, target_reduction)
        return x, 2 * it, res

    monkeypatch.setattr(krylov.BicgstabLoop, "solve", altered)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload, fault", [
    ("poisson2d_511.search", unchanged_state),
    ("poisson2d_511.search", altered_rate),
    ("poisson2d_511.solve", unchanged_state),
    ("poisson2d_511.solve", altered_verdict),
    ("helmholtz2d_127.outer", unchanged_state),
    ("helmholtz2d_127.outer", altered_count),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = run(workload)
    assert not result["correct"], result["checks"]


def test_a_run_without_a_card_ends_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(harness.Failure):
        harness.run(ROOT, "poisson2d_511.search", 1, 1.0, False, time.monotonic())


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "poisson2d_511.search", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
