"""The `dispatch` kind (poisson2d_511_dp4.search) on the CPU at a small size
with two gloo ranks: a sound run is correct and reads the dispatch counters;
a rank's rows dropped, the gathered list shifted by one place and one
worker's ρ scaled by 1.01 each read `correct` false; a worker killed in the
window ends the run at once with every process gone; a worker that loads a
forbidden module ends it without a result.  Faults in a worker come from a
wrapper that patches the port and then runs portbench/dispatch_worker.py."""

import os
import subprocess
import sys
import time

import pytest
import torch

from evostencils_torch.parallel import dispatch
from portbench import harness
from portbench.kinds import dispatch as dispatch_kind

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "poisson2d_511_dp4.search"
TIMEOUT_S = 60
# Four trees that converge at 63², one timing sample: a batch takes a few
# seconds here, so a window of 8 s returns every record of its first batch.
SMALL = {"config": {"min_level": 2, "max_level": 6, "ranks": 2, "population": 4,
                    "evaluation_samples": 1},
         "traffic": {"order": [7, 8, 3, 11], "check_trees": 4,
                     "collective_timeout_s": TIMEOUT_S}}

WRAPPER = """
import os, runpy, signal, sys, time
sys.path.insert(0, {root!r})
from evostencils_torch.backend import evaluation
from evostencils_torch.parallel import dispatch
with open({pids!r}, "a") as fh:
    fh.write(f"{{os.getpid()}}\\n")
{fault}
runpy.run_path({worker!r}, run_name="__main__")
"""

WORKER_FAULTS = {
    "rows_dropped": """
gather = dispatch.MultiHostDispatcher._gather
dispatch.MultiHostDispatcher._gather = lambda self, count, mine, local: gather(self, count, [], [])
""",
    "rho_scaled": """
block_rate = evaluation.PowerLoop.block_rate
def altered(self):
    block_rate(self)
    self.rate.mul_(1.01)
evaluation.PowerLoop.block_rate = altered
""",
    "killed": """
map_ = dispatch.MultiHostDispatcher.map
calls = []
def dying(self, fn, items):
    calls.append(1)
    if len(calls) == 3:  # set-up's map, the window's first batch, then its second
        with open({killed!r}, "w") as fh:
            fh.write(repr(time.time()))
        os.kill(os.getpid(), signal.SIGKILL)
    return map_(self, fn, items)
dispatch.MultiHostDispatcher.map = dying
""",
    "forbidden": """
import types
sys.modules["flax"] = types.ModuleType("flax")
""",
}


def run(seconds=8.0, trace=False):
    return harness.run(ROOT, CELL, 2 ** 31 + 7, seconds, trace, time.monotonic(), device="cpu",
                       overrides=SMALL)


@pytest.fixture
def faulty_worker(monkeypatch, tmp_path):
    """Makes the workers run `fault`; returns the file their pids go to."""
    pids = tmp_path / "pids"

    def install(fault):
        wrapper = tmp_path / "worker.py"
        code = WORKER_FAULTS[fault].replace("{killed!r}", repr(str(tmp_path / "killed")))
        wrapper.write_text(WRAPPER.format(root=ROOT, pids=str(pids), fault=code,
                                          worker=dispatch_kind.WORKER))
        monkeypatch.setattr(dispatch_kind, "WORKER", str(wrapper))
        return pids

    return install


def gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_a_sound_run_of_two_ranks_is_correct():
    result = run(trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 4
    assert set(result["checks"]) == {"rho_gap", "iteration_gap", "lost_results",
                                     "rank_disagreements"}
    metrics = result["metrics"]
    assert 0.0 <= metrics["gather_wait_share.dp4"]["value"] <= 100.0
    assert metrics["rank_imbalance.dp4"]["value"] >= 1.0
    assert not torch.distributed.is_initialized()


def shifted_gather(monkeypatch):
    gather = dispatch.MultiHostDispatcher._gather

    def shifted(self, count, mine, local_results):
        results = gather(self, count, mine, local_results)
        return results[-1:] + results[:-1]

    monkeypatch.setattr(dispatch.MultiHostDispatcher, "_gather", shifted)


@pytest.mark.parametrize("fault", ["rows_dropped", "shifted_indices", "rho_scaled"])
def test_a_broken_deployment_is_not_correct(fault, faulty_worker, monkeypatch):
    if fault == "shifted_indices":  # on rank 0, this process
        shifted_gather(monkeypatch)
    else:
        faulty_worker(fault)
    result = run()
    assert result["attempted"] > 4
    assert not result["correct"], result["checks"]


def test_a_killed_worker_ends_the_run_with_every_process(faulty_worker, tmp_path):
    pids = faulty_worker("killed")
    with pytest.raises(SystemExit):
        run(seconds=600.0)
    ended = time.time()
    killed = float((tmp_path / "killed").read_text())
    assert ended - killed < TIMEOUT_S
    workers = [int(p) for p in pids.read_text().split()]
    assert len(workers) == 1 and all(gone(pid) for pid in workers)
    assert not torch.distributed.is_initialized()


def test_a_worker_that_loads_a_forbidden_module_gives_no_result(faulty_worker):
    faulty_worker("forbidden")
    with pytest.raises(harness.Failure, match="flax"):
        run()


def report(rank, cards, digests):
    return {"rank": rank, "cards": cards, "digests": digests, "forbidden": []}


def check(reports, device):
    """The kind's check of a window without records over `reports`."""
    config, traffic = harness.load_cell(ROOT, CELL)[2:]
    limits = harness.load_json(os.path.join(ROOT, "portbench", "limits", f"{CELL}.json"))
    return dispatch_kind.check(config, traffic, 1, [], torch.device(device), limits,
                               {"reports": reports, "lost": 0})


@pytest.mark.parametrize("cards, shared", [
    ([[0], [1], [2], [3]], 0),
    ([[0], [0], [2], [3]], 1),  # two ranks on card 0
    ([[0], [0, 1], [2], [3]], 1),  # rank 1's threads on card 0 as well
    ([[0], [0], [0], [0]], 3),
])
def test_shared_cards_counts_the_cards_the_ranks_lack(cards, shared):
    checks = check([report(r, c, ["a"]) for r, c in enumerate(cards)], "cuda")
    assert checks["shared_cards"]["value"] == shared


@pytest.mark.parametrize("digests, disagreements", [
    ([["a", "b"], ["a", "b"]], 0),
    ([["a", "b"], ["a", "c"]], 1),
    ([["a", "b"], ["a"]], 1),  # a batch the worker never gathered
    ([["a", "b"], ["x", "y"], ["a", "b"], ["a", "z"]], 3),
])
def test_rank_disagreements_count_rank_and_batch_pairs(digests, disagreements):
    checks = check([report(r, [r], d) for r, d in enumerate(digests)], "cpu")
    assert checks["rank_disagreements"]["value"] == disagreements
    assert "shared_cards" not in checks


@pytest.mark.parametrize("module", ["portbench.kinds.dispatch", "portbench.dispatch_worker"])
def test_loading_the_kind_and_its_worker_loads_no_jax(module):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {module}; "
            "from portbench import harness; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
