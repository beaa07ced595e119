"""The benchmark's runner: one cell of BENCHMARK.json, one process.

A cell names a configuration (configs/<config>.json) and a traffic mix
(traffic/<traffic>.json); the limits of its comparison with the reference
are limits/<cell>.json.  The mix names its kind of work (kinds/<kind>.py),
whose module builds the program's objects from the configuration, warms up, runs
one request at a time, counts what the program counts, and judges the
window's results against the plain reference (reference/).  Each per-layer
metric is a reader of its own (metrics/<metric>.py).  Nothing here knows a
cell, a mix or a metric by name.

The run: set-up (the kind's construction and warm-up) from process start
to the window's start; the window, a closed loop of one caller that ends at
the first completion after `seconds`; with tracing, torch.profiler over
the window's first requests; then the program's state is freed and the
reference judges the results.  The result is one JSON line on stdout.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from portbench.trace import Profile, Spans, TraceSummary

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "evostencils_tpu")


class Failure(Exception):
    """A run that must end without a result."""


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(root: str, name: str):
    """(spec, cell, config, traffic) for the workload `name`."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise Failure(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, config_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    return spec, cell, config, traffic


def metrics_for(spec: dict, cell: dict, trace: bool):
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell["name"] in m.get("workloads", [cell["name"]])]


def load_reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    module_spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def save_request_times(root: str, workload: str, seed: int, records: list) -> None:
    """Each request's completion (s from the window's start) and what it ran,
    a few kB in portbench_out/: to tell a run that is slow throughout from
    one with a few stalls."""
    rows = [[round(r["done_s"], 6), r.get("tree", r.get("candidate"))] for r in records]
    os.makedirs(os.path.join(root, "portbench_out"), exist_ok=True)
    with open(os.path.join(root, "portbench_out", f"{workload}.{seed}.requests.json"), "w") as fh:
        json.dump(rows, fh)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as error:
        return f"nvidia-smi: {error}"


def device_record(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """One run of one cell; the result's dict.  `started`: the process's
    start on the monotonic clock.  `device` "cpu" and `overrides` (keys of
    the config, the traffic mix and the limits to replace) are for tests at
    small sizes."""
    spec, cell, config, traffic = load_cell(root, workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise Failure(f"{workload} needs {cell['chips']} CUDA device(s), found {found}")
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    spans = Spans()
    work = kind.Work(config, traffic, seed, device, spans)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()

    # The window.  Spans count from here on.
    spans.seconds.clear()
    spans.counts.clear()
    traced = int(traffic.get("trace_requests", 0)) if trace else 0
    profile = Profile() if traced and device.type == "cuda" else None
    before = work.counters()
    sub_before = sub_after = None
    sub_window_s = 0.0
    events = []
    records, failed = [], 0
    t_start = time.perf_counter()
    setup_s = time.monotonic() - started
    i = 0
    while True:
        if profile is not None and i == 0:
            profile.start()
            sync()
            spans.markers = True
            sub_before = work.counters()
            t_sub = time.perf_counter()
        try:
            with spans.enter("request"):
                record = work.request(i)
            sync()
            if record.get("failed"):
                failed += 1
        except Exception as error:  # a failed operation: counted, the run goes on
            print(f"request {i} failed: {type(error).__name__}: {error}", file=sys.stderr)
            record = {"failed": True, "error": repr(error)[:200]}
            failed += 1
        record["done_s"] = time.perf_counter() - t_start
        records.append(record)
        i += 1
        if profile is not None and i == traced:
            sync()
            sub_window_s = time.perf_counter() - t_sub
            spans.markers = False
            sub_after = work.counters()
            events = profile.stop()
            profile = None
        if record["done_s"] >= seconds and profile is None:
            break
    window_s = records[-1]["done_s"]
    after = work.counters()
    dev = device_record(device, cell["chips"])

    # The program's state goes before the reference runs.
    kept = work.release()
    del work
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = load_json(os.path.join(HERE, "limits", f"{workload}.json"))
    if overrides:
        limits = {**limits, **overrides.get("limits", {})}
    checks = kind.check(config, traffic, seed, records, device, limits, kept)
    if hasattr(kind, "describe"):
        print(kind.describe(records), file=sys.stderr)
    if traced and device.type == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)

    context = {
        "window_s": window_s, "setup_s": setup_s, "records": records,
        "completed": sum(1 for r in records if not r.get("failed")),
        "counters_before": before, "counters_after": after, "spans": spans,
        "trace": None,
    }
    if traced and sub_after is not None:
        launches = {k: sub_after["rb_sweep_launches"].get(k, 0)
                    - sub_before["rb_sweep_launches"].get(k, 0)
                    for k in sub_after["rb_sweep_launches"]}
        summary = TraceSummary(events, spans.labels, sub_window_s, traced,
                               {k: v for k, v in launches.items() if v})
        context["trace"] = summary
        summary.save(os.path.join(root, "portbench_out", f"{workload}.{seed}.trace.npz"), events)
    metrics = {}
    for entry in metrics_for(spec, cell, trace):
        value = load_reader(entry["name"])(context)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if context["trace"] is not None:
        result["device"]["busy_s"] = context["trace"].busy_s
        result["device"]["window_s"] = context["trace"].window_s
        result["breakdown"] = context["trace"].breakdown()
    result["checks"] = checks
    save_request_times(root, workload, seed, records)
    # Last, once every reader has loaded and run: what the process holds now
    # is all that the run loaded.
    found = forbidden_modules()
    if found:
        raise Failure(f"modules that must not load: {', '.join(found)}")
    return result

