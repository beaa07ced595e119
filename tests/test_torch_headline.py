"""scripts/torch_headline_1024.py end to end on the CPU at a small size
(levels 3-5, 31² finest): every solver reaches the 1e-10 target in host
IEEE float64, its JSON file holds the rows, and every time is labelled a
host time, never a device metric."""

import json

from scripts import torch_headline_1024

TARGET = 1e-10


def test_headline_script_on_the_cpu(tmp_path):
    path = tmp_path / "headline.json"
    rows = torch_headline_1024.run(["--cpu", "--min-level", "3", "--max-level", "5",
                                    "--predicted", "--repeats", "1", "--json", str(path)])
    assert [r["solver"] for r in rows] == ["textbook V(2,1)", "textbook V(2,2)"]
    for row in rows:
        assert row["reached_target"] and row["rel_residual"] <= TARGET
        assert row["clock"] == "host perf_counter" and row["device"] == "cpu"
        assert row["compute_ms"] > 0 and row["modeled_bytes_per_cycle"] > 0
        assert row["measured_floor"] is not None and not row["rb_sweep_launches_by_shape"]
        # The CPU solves eagerly: no graph, no eager comparison unless asked.
        assert (row["cuda_graphs"], row["captures"], row["graph_bytes"]) == (False, 0, 0)
        assert row["eager"] is None
    assert json.loads(path.read_text())["rows"] == json.loads(json.dumps(rows))
