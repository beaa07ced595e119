"""docs/torch_tutorial.py is executable documentation of the port: it must
run end to end on the CPU (problem file, textbook cycle, evolution,
re-evaluating the champion from its string, gradient ω tuning) without a
card, and stop without one unless TUTORIAL_DEVICE=cpu."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(**environment):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **environment)
    return subprocess.run(
        [sys.executable, str(ROOT / "docs" / "torch_tutorial.py")],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)


def test_torch_tutorial_runs_end_to_end_on_the_cpu():
    out = _run(TUTORIAL_DEVICE="cpu", TUTORIAL_GENERATIONS="2", TUTORIAL_MU="3")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "loaded 2D_FD_Poisson_fromL2.exa2" in out.stdout
    assert "champion re-evaluated" in out.stdout
    assert "tutorial complete" in out.stdout


def test_torch_tutorial_needs_the_card_or_cpu():
    # An empty CUDA_VISIBLE_DEVICES hides any card from torch.
    out = _run(TUTORIAL_DEVICE="cuda", CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 2
    assert "TUTORIAL_DEVICE=cpu" in out.stderr and "tutorial complete" not in out.stdout
