"""The benchmark's tests: `python -m pytest portbench/tests -q` from the root
of the repository (about two minutes on the CPU).  Tests marked `cuda` need
a card and skip without one; on the card run them with
`python -m pytest portbench/tests -m cuda -q`."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.setrecursionlimit(100000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
