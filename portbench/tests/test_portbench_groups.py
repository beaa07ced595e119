"""The groups cell on the CPU at levels 2-6 (63² finest), two of its groups
of 8: a whole run as it is, one with a member's ρ off by 1 %, and one
against a program without the group counters; the cell's own readers on
synthetic runs; the frozen group file against what its script writes; and
neither the kind nor the script loads JAX or the JAX package."""

import importlib.util
import os
import subprocess
import sys
import time

import pytest

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils import profiling
from evostencils_torch.utils.profiling import Span
from portbench import harness
from portbench.kinds import common, groups

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "poisson2d_511.groups"
SMALL = {"config": {"min_level": 2, "max_level": 6},
         "traffic": {"order": [3, 1], "check_members": 16}}
NEW = ["rb_sweep_roofline.groups", "member_block_use.groups", "batched_share.groups",
       "power_share.groups", "device_ms_per_eval.groups", "idle_share.groups"]
COUNTED = ["member_block_use.groups", "batched_share.groups"]


def run(trace=False):
    return harness.run(ROOT, CELL, 2 ** 31 + 11, 1.0, trace, time.monotonic(), device="cpu",
                       overrides=SMALL)


def test_a_sound_run_is_correct_and_every_group_is_batched():
    result = run(trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"]["batched_share.groups"]["value"] == pytest.approx(100.0)
    assert 0.0 < result["metrics"]["member_block_use.groups"]["value"] <= 100.0


def test_a_member_off_by_one_percent_is_not_correct(monkeypatch):
    rates = TorchProgramGenerator._batched_rates

    def altered(self, *args):
        out = rates(self, *args)
        return [1.01 * out[0]] + out[1:]

    monkeypatch.setattr(TorchProgramGenerator, "_batched_rates", altered)
    result = run()
    assert not result["correct"], result["checks"]
    assert result["checks"]["rho_gap"]["value"] > result["checks"]["rho_gap"]["limit"]


def test_a_program_without_group_counters_runs_and_reads_none(monkeypatch):
    monkeypatch.delattr(TorchProgramGenerator, "group_stats")
    result = run(trace=True)
    assert result["correct"], result["checks"]
    assert not set(COUNTED) & set(result["metrics"])


def _context(spans=None, group=True):
    counters = [{"members_evaluated": n} for n in (16, 48)]
    if group:
        counters[0]["group"] = {"batched_members": 16, "member_blocks_run": 64,
                                "member_blocks_used": 40}
        counters[1]["group"] = {"batched_members": 48, "member_blocks_run": 192,
                                "member_blocks_used": 120}
    return {"counters_before": counters[0], "counters_after": counters[1], "completed": 30,
            "trace": None if spans is None else object(), "program_spans": spans,
            "records": [], "window_s": 1.0, "setup_s": 1.0, "spans": None}


def read(name, context):
    return harness.load_reader(name)(context)


def test_every_new_metric_has_a_reader_and_an_entry():
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "evals_per_hour"
        assert callable(harness.load_reader(name))
    (entry,) = [m for m in spec["end_to_end"] if m["name"] == "evals_per_hour"]
    assert CELL in entry["workloads"]


def test_the_counter_readers():
    context = _context()
    # 32 members handed over, all batched; 80 of 128 member blocks used.
    assert read("batched_share.groups", context) == pytest.approx(100.0)
    assert read("member_block_use.groups", context) == pytest.approx(100 * 80 / 128)
    for name in COUNTED:
        assert read(name, _context(group=False)) is None


def test_the_power_share_reader():
    spans = [Span("evaluate_group", 0, 100, -1, 1), Span("evaluate.build", 0, 5, 0, 1),
             Span("loop.power_batched", 10, 60, 0, 1), Span("loop.stage", 60, 90, 0, 1),
             Span("evaluate_group", 200, 300, -1, 2),
             Span("loop.power_batched", 210, 240, 4, 2)]
    assert read("power_share.groups", _context(spans)) == pytest.approx(100 * 80 / 200)
    # The parent's program: no evaluate_group root, and no batched span.
    parent = [Span("evaluate.build", 0, 5, -1, 0), Span("loop.power", 10, 60, -1, 0)]
    assert read("power_share.groups", _context(parent)) is None
    assert read("power_share.groups", _context()) is None


def test_the_recorder_names_the_group_spans(monkeypatch):
    """What the reader looks for is what the program records."""
    monkeypatch.setattr(profiling, "recording", lambda: True)
    profiling.take()
    config = {**harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                               "poisson2d_511_groups.json")), **SMALL["config"]}
    problem = poisson_2d(2, 6)
    pset, _ = common.primitive_set(problem, config)
    texts, members = groups.read_groups(common.data_path("data/{config}.txt", config))
    generator = TorchProgramGenerator(problem, device="cpu")
    generator.generate_and_evaluate_group(
        [gp.compile_tree(gp.parse_tree(texts[m], pset), pset)[0] for m in members[9][:2]],
        evaluation_samples=1)
    names = [s.name for s in profiling.take().spans]
    # compile_tree's own root spans come first.
    assert names.count("evaluate_group") == 1
    inside = names[names.index("evaluate_group") + 1:]
    assert {"evaluate.build", "evaluate.probe_state", "loop.power_batched",
            "evaluate.timing"} <= set(inside) and "loop.power" not in inside


def test_the_group_file_is_what_its_script_writes():
    path = os.path.join(ROOT, "portbench", "data", "make_groups.py")
    spec = importlib.util.spec_from_file_location("make_groups", path)
    make_groups = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_groups)
    config = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                            "poisson2d_511_groups.json"))
    search = harness.load_json(os.path.join(ROOT, "portbench", "traffic", "search.json"))
    with open(os.path.join(ROOT, "portbench", "data", "poisson2d_511_trees.txt")) as fh:
        pool = [line.strip() for line in fh if line.strip()]
    written = make_groups.lines(make_groups.make_groups(pool, search["order"],
                                                        make_groups.primitive_set(config)))
    with open(os.path.join(ROOT, "portbench", "data", "poisson2d_511_groups.txt")) as fh:
        assert fh.read() == written
    _, by_group = groups.read_groups(
        os.path.join(ROOT, "portbench", "data", "poisson2d_511_groups.txt"))
    assert [len(g) for g in by_group] == [16, 8] * 6


def test_loading_the_kind_and_its_script_loads_no_jax():
    code = (f"import sys, importlib.util; sys.path.insert(0, {ROOT!r}); "
            "import portbench.kinds.groups; "
            "spec = importlib.util.spec_from_file_location('make_groups', "
            f"{os.path.join(ROOT, 'portbench', 'data', 'make_groups.py')!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "from portbench import harness; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
