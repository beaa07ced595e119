"""Time the port's red-black sweep kernel level by level on one GPU.

    python3 scripts/torch_rb_sweep_levels.py                 # this checkout
    python3 scripts/torch_rb_sweep_levels.py --ab OTHER_ROOT # OTHER, this, this, OTHER

Default: the 5-point stencil at every level of the main path (63² to
1023²), device time as chip_smoke.py measures it (evostencils_torch/
measure.py: 50 calls queued back to back behind a spin kernel, median of
5), L2 warm as the main path finds it, beside the level's bound (12 bytes
a point over 3.35 TB/s).

--ab OTHER_ROOT: the default timing for another checkout of the port (for
example the parent commit, unpacked with `git archive`) and for this one,
in turns OTHER, this, this, OTHER, each in its own process on the same
card, so the two kernels compare inside one run.  Both are timed by this
checkout's measure.py.

Each result is one JSON line; the last line holds them all.  Needs a CUDA
card and nvcc; builds each checkout's kernels at first use.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OMEGA = 1.15
FIVE_POINT = (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0))


def _this_checkouts_measure():
    """evostencils_torch/measure.py of this checkout, loaded by its path so
    that the package imported after it may come from another checkout."""
    spec = importlib.util.spec_from_file_location(
        "_rb_sweep_levels_measure", os.path.join(ROOT, "evostencils_torch", "measure.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_levels(root: str) -> list:
    """The wrapper of the checkout at `root`, level by level."""
    measure = _this_checkouts_measure()
    sys.path.insert(0, root)
    from evostencils_torch.ops import rb_sweep

    stencil = rb_sweep.constant.Stencil(FIVE_POINT)
    omega = torch.full((1,), OMEGA, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(4)
    levels = []
    for shape in measure.LEVELS:
        u, f = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
                for _ in range(2))
        ms = measure.median_device_ms(
            lambda: rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil))
        bound = measure.bound_ms(shape)
        levels.append({"root": root, "shape": list(shape), "ms": ms,
                       "bound_ms": bound, "share_of_bound": bound / ms})
        print(json.dumps(levels[-1]), flush=True)
    return levels


def compare(other: str) -> list:
    """OTHER, this, this, OTHER: one process each, on the same card."""
    results = []
    for root in (other, ROOT, ROOT, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", os.path.abspath(root)],
            capture_output=True, text=True, check=True, timeout=600,
        )
        levels = json.loads(proc.stdout.strip().splitlines()[-1])["levels"]
        for level in levels:
            print(json.dumps(level), flush=True)
        results += levels
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT, help="checkout whose port is timed")
    parser.add_argument("--ab", metavar="OTHER_ROOT", help="compare with another checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: nothing was timed", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = {"levels": compare(args.ab) if args.ab else time_levels(args.root)}
    print(smi, flush=True)
    print(json.dumps({"card": smi, **results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
