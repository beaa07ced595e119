"""The port's champion scripts on the CPU: torch_evaluate_reference_solver,
torch_evaluate_evolved_solver, torch_champion_stats and
torch_tune_champions (counterparts of the JAX package's scripts of the
same names without the prefix).

Each runs with --cpu on a small hierarchy and few samples and prints what
the reference script prints (champion_stats: its JSON report's keys, which
the stored n = 20 records hold); each exits 2 without a card unless given
--cpu.  `torch_champion_stats.measure` is held against the reference's
`scripts.champion_stats.measure` with float64 generators on the same
seeded right-hand sides (residual target 1e-6, the float64 parity target
of tests/test_torch_slice.py): median ρ within 1e-6 relative, equal
iterations.  The tuner's file must read back through parse_champion_file
and its ω must apply.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from scripts import champion_stats as jax_champion_stats
from scripts import (
    torch_champion_stats, torch_evaluate_evolved_solver, torch_evaluate_reference_solver,
    torch_tune_champions,
)
from torch_parity import JAX, PORT, Side

ROOT = Path(__file__).resolve().parents[1]
CHAMPION = str(ROOT / "artifacts" / "paper_protocol" / "individual_0.txt")
TUNED_CHAMPION = str(ROOT / "artifacts" / "paper_protocol" / "individual_0_tuned.txt")
# The stored champions were evolved for five levels (a depth-4 grammar);
# levels 1-5 keep all five with a 31² finest grid.
SMALL = ["--min-level", "1", "--max-level", "5"]
SCRIPTS = {
    "torch_evaluate_reference_solver": torch_evaluate_reference_solver,
    "torch_evaluate_evolved_solver": torch_evaluate_evolved_solver,
    "torch_champion_stats": torch_champion_stats,
    "torch_tune_champions": torch_tune_champions,
}
POSITIONAL = {"torch_evaluate_evolved_solver": [CHAMPION],
              "torch_champion_stats": [TUNED_CHAMPION],
              "torch_tune_champions": [CHAMPION]}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_exits_2_without_a_card_unless_cpu(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        SCRIPTS[name].main(POSITIONAL.get(name, []))
    assert exit_info.value.code == 2
    assert "--cpu" in capsys.readouterr().err


def test_reference_solver_prints_the_reference_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_evaluate_reference_solver.py"), "--cpu",
         "--min-level", "3", "--max-level", "5", "--samples", "2"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Reference V(2,1) RB-Jacobi cycle on 2D_FD_Poisson" in proc.stdout
    for label in ("Time to convergence:", "Convergence factor:", "Iterations:"):
        assert label in proc.stdout, label


def test_evolved_solver_reevaluates_the_stored_string(capsys):
    result = torch_evaluate_evolved_solver.run(
        ["--cpu", *SMALL, "--evaluation-samples", "2", CHAMPION])
    out = capsys.readouterr().out
    for label in ("Time to convergence:", "Convergence factor:", "Iterations:"):
        assert label in out, label
    assert 0 < result["convergence_factor"] < 0.2 and result["iterations"] <= 12
    assert result["device"] == "cpu"


def test_champion_stats_writes_the_reference_report(tmp_path):
    report_path = tmp_path / "stats.json"
    report = torch_champion_stats.run(
        ["--cpu", *SMALL, "--samples", "3", TUNED_CHAMPION, "--json", str(report_path)])
    assert json.loads(report_path.read_text()) == report
    # The layout of the reference's report: its keys, as the stored records
    # hold them, plus the device's name.
    record = json.loads((ROOT / "artifacts" / "paper_protocol" /
                         "poisson2d_stats_n20_f32.json").read_text())
    assert set(record) <= set(report)
    assert set(report) == {"problem", "levels", "helmholtz_k0", "outer_cap", "vary",
                           "samples", "platform", "device", "champions"}
    (entry,) = report["champions"]
    assert set(entry) == set(record["champions"][0]) == {
        "file", "has_stored_omegas", "untuned", "tuned"}
    for label in ("untuned", "tuned"):
        assert set(entry[label]) == set(record["champions"][0][label])
        for stats in entry[label].values():
            assert set(stats) == {"n", "min", "median", "max", "failed"}
            assert stats["n"] == 3
    assert entry["tuned"]["rho"]["median"] < entry["untuned"]["rho"]["median"] < 0.2
    assert (report["platform"], report["device"], report["levels"]) == ("cpu", "cpu", [1, 5])


def test_champion_stats_measure_matches_the_reference():
    tree_string, omegas = parse_champion_file(TUNED_CHAMPION)
    # Levels 2-6 (63²): at levels 1-5 the JAX package's block smoother
    # fails to broadcast on the 3² grid, where the port's runs.
    jax_side = Side(JAX, jax_poisson_2d(2, 6, dtype=jnp.float64))
    port_side = Side(PORT, poisson_2d(2, 6, dtype=torch.float64))
    jax_expr = jax_side.compile(tree_string)
    port_expr = port_side.compile(tree_string)
    # The reference's loader of stored ω is the same function in both packages.
    assert apply_stored_omegas(port_expr, omegas, label="port")
    from evostencils_tpu.utils.champions import apply_stored_omegas as jax_apply_stored_omegas

    assert jax_apply_stored_omegas(jax_expr, omegas, label="reference")
    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, epsilon=1e-6)
    port = TorchProgramGenerator(port_side.problem, dtype=torch.float64, epsilon=1e-6,
                                 device="cpu")
    for vary in ("rhs", "init"):
        _, rhos_ref, its_ref = jax_champion_stats.measure(reference, jax_expr, 3, vary=vary)
        _, rhos, its = torch_champion_stats.measure(port, port_expr, 3, vary=vary)
        median, median_ref = sorted(rhos)[1], sorted(rhos_ref)[1]
        assert abs(median - median_ref) <= 1e-6 * median_ref, (vary, rhos, rhos_ref)
        assert its == its_ref, (vary, its, its_ref)
        assert (port.rhs_seed, port.init_seed) == (None, None)


def test_tune_champions_writes_a_file_that_reads_back(tmp_path, capsys):
    stored = Path(TUNED_CHAMPION).read_text()
    (record,) = torch_tune_champions.run(
        ["--cpu", *SMALL, "--samples", "1", "--iterations", "5", CHAMPION,
         "--output-dir", str(tmp_path)])
    out = capsys.readouterr().out
    written = tmp_path / "individual_0_tuned.txt"
    assert record["output"] == str(written) and f"-> {written}" in out
    tree_string, omegas = parse_champion_file(str(written))
    assert tree_string == parse_champion_file(CHAMPION)[0]
    assert omegas == [round(w, 4) for w in record["omegas"]]
    assert record["rho_after"] <= record["rho_before"]
    side = Side(PORT, poisson_2d(1, 5, dtype=torch.float32))
    assert apply_stored_omegas(side.compile(tree_string), omegas, label=str(written))
    # --output-dir left the stored file beside the input alone.
    assert Path(TUNED_CHAMPION).read_text() == stored
