#!/usr/bin/env python
"""Calibrate the port's roofline model (evostencils_torch/models/roofline.py)
against per-cycle device times on the card (the counterpart of
scripts/calibrate_roofline.py).

Measures the reference's eight lowered cycles (V(2,1) and V(2,2) with
red-black smoothing, V(2,2) with plain Jacobi, and a chain of four
red-black smoothing steps, at 511² and 1023²) on the card, each cycle
captured in a CUDA graph and replayed (utils/timing.per_cycle_time: device
seconds, not the host's dispatch), and the wall time of one eager cycle
beside it.  Then fits the model's free constants in the reference's two
stages, by the least sum of squared log-ratios of predicted to measured:
  1. red_black_penalty, fusion_factor, intergrid_factor and, unlike the
     TPU fit (which pinned it to 0), kernel_launch_overhead, on the
     red-black cases: every torch op is a kernel launch with a device-side
     cost, which dominates the coarse levels;
  2. single_sweep_fusion alone on the Jacobi cases.
The walker is bandwidth-bound at every calibration node, so for fixed
penalty and intergrid factor a case's predicted time is c + a/fusion +
b·overhead: stage 1 walks each case three times per (penalty, intergrid)
pair and searches fusion and overhead on that closed form; the predicted
times it writes are direct walks with the fitted constants.

Writes evostencils_torch/models/roofline_calibration_h100.json (the keys of
artifacts/roofline_calibration.json, `device` from nvidia-smi, each case
with its wall time too); tests/test_torch_models.py holds the committed
*_H100 constants to it and every case to the reference's gate of 1/1.35 to
1.35.

Run on the card:   python3 scripts/torch_calibrate_roofline.py
Refit the stored measurements (no card):
                   python3 scripts/torch_calibrate_roofline.py --refit
"""

import json
import os
import subprocess
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir import base, smoother
from evostencils_torch.ir import partitioning as part
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.ir.transformations import invalidate_expression
from evostencils_torch.models.roofline import PerformanceEvaluator
from evostencils_torch.problems.poisson import poisson_2d

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "evostencils_torch", "models", "roofline_calibration_h100.json")
GATE = 1.35
PENALTIES = np.geomspace(0.25, 4.0, 25)
INTERGRIDS = np.geomspace(0.25, 16.0, 25)
FUSIONS = np.geomspace(0.05, 20.0, 121)
OVERHEADS = np.concatenate([[0.0], np.geomspace(1e-8, 1e-4, 81)])
SINGLE_FUSIONS = np.geomspace(0.05, 8.0, 101)


def build_cases():
    """(name, problem, expression) of the reference's calibration cases."""
    cases = []
    for max_level, min_level in ((9, 5), (10, 6)):
        problem = poisson_2d(min_level=min_level, max_level=max_level, dtype=torch.float32)
        _, tl = generate_primitive_set(
            problem.approximation(), problem.rhs(), 2, problem.coarsening_factors, max_level,
            problem.equations, problem.operators, problem.fields,
            depth=max_level - min_level, maximum_local_system_size=8,
        )
        n = 2 ** max_level
        cases.append((f"V(2,1)_rb_{n}", problem, generate_v_cycle(tl, problem.rhs(), 2, 1)))
        cases.append((f"V(2,2)_rb_{n}", problem, generate_v_cycle(tl, problem.rhs(), 2, 2)))
        cases.append((f"V(2,2)_jacobi_{n}", problem,
                      generate_v_cycle(tl, problem.rhs(), 2, 2, partitioning=part.Single)))
        # Smoothing-only chain (no coarse correction): isolates the sweep
        # cost the red-black penalty models.
        t0 = tl[0]
        u, fr, A = t0.approximation, problem.rhs(), t0.operator
        ucur = u
        for _ in range(4):
            res = base.Residual(A, ucur, fr)
            corr = base.Multiplication(base.Inverse(smoother.generate_collective_jacobi(A)), res)
            ucur = base.Cycle(ucur, fr, corr, partitioning=part.RedBlack, relaxation_factor=1.0)
        cases.append((f"smooth4_rb_{n}", problem, ucur))
    return cases


def measure(cases, device="cuda", iters=100, repeats=7):
    """[(name, expression, device seconds, wall seconds)] per cycle."""
    from evostencils_torch.backend.lowering import CycleLowering
    from evostencils_torch.utils.timing import per_cycle_time, wall_cycle_time

    measured = []
    for name, problem, expr in cases:
        step = CycleLowering(torch.float32, device).lower(expr)
        u0, f = problem.initial_state(torch.float32, device=device)
        t = per_cycle_time(step, u0, f, iters=iters, repeats=repeats)
        wall = wall_cycle_time(step, u0, f)
        measured.append((name, expr, t, wall))
        print(f"{name}: {1e6 * t:.2f} us/cycle on the device, {1e6 * wall:.1f} us wall",
              flush=True)
    return measured


def model_time(expr, **constants) -> float:
    invalidate_expression(expr)
    return PerformanceEvaluator(**constants).estimate_runtime(expr)


def _affine(expr, penalty, intergrid):
    """(c, a, b) with predicted = c + a/fusion + b·overhead."""
    fixed = dict(red_black_penalty=penalty, intergrid_factor=intergrid, single_sweep_fusion=1.0)
    r1 = model_time(expr, fusion_factor=1.0, kernel_launch_overhead=0.0, **fixed)
    r2 = model_time(expr, fusion_factor=2.0, kernel_launch_overhead=0.0, **fixed)
    r3 = model_time(expr, fusion_factor=1.0, kernel_launch_overhead=1e-6, **fixed)
    a = 2.0 * (r1 - r2)
    return r1 - a, a, (r3 - r1) / 1e-6


def fit(measured, penalties=PENALTIES, intergrids=INTERGRIDS, fusions=FUSIONS,
        overheads=OVERHEADS, single_fusions=SINGLE_FUSIONS) -> dict:
    """The two-stage fit; returns the constants and the log-rmse."""
    rb = [m for m in measured if "_jacobi_" not in m[0]]
    jacobi = [m for m in measured if "_jacobi_" in m[0]]
    log_m = np.log([m[2] for m in rb])[:, None, None]
    inv_f = (1.0 / fusions)[None, :, None]
    o = overheads[None, None, :]
    best = None
    for penalty in penalties:
        for intergrid in intergrids:
            coeffs = np.array([_affine(m[1], float(penalty), float(intergrid)) for m in rb])
            c, a, b = (coeffs[:, i][:, None, None] for i in range(3))
            err = np.sum((np.log(c + a * inv_f + b * o) - log_m) ** 2, axis=0)
            i, j = np.unravel_index(np.argmin(err), err.shape)
            if best is None or err[i, j] < best[0]:
                best = (float(err[i, j]), float(penalty), float(fusions[i]), float(intergrid),
                        float(overheads[j]))
    err_rb, penalty, fusion, intergrid, overhead = best
    shared = dict(red_black_penalty=penalty, kernel_launch_overhead=overhead,
                  fusion_factor=fusion, intergrid_factor=intergrid)
    best2 = None
    for sf in single_fusions:
        err = sum((np.log(model_time(m[1], single_sweep_fusion=float(sf), **shared))
                   - np.log(m[2])) ** 2 for m in jacobi)
        if best2 is None or err < best2[0]:
            best2 = (float(err), float(sf))
    err_jacobi, single_fusion = best2
    return {**shared, "single_sweep_fusion": single_fusion,
            "log_rmse": float(np.sqrt((err_rb + err_jacobi) / len(measured)))}


def _device_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.setrecursionlimit(100000)
    refit = "--refit" in argv
    cases = build_cases()
    if refit:
        with open(PATH) as fh:
            stored = json.load(fh)
        by_name = {c["case"]: c for c in stored["cases"]}
        measured = [(name, expr, by_name[name]["measured_s"], by_name[name].get("wall_s"))
                    for name, _, expr in cases]
        device = stored["device"]
    else:
        if not torch.cuda.is_available():
            print("torch_calibrate_roofline: no CUDA device (use --refit to refit the "
                  "stored measurements)", file=sys.stderr)
            return 2
        measured = measure(cases)
        device = _device_name()

    constants = fit(measured)
    log_rmse = constants.pop("log_rmse")
    print(f"\nfit: red_black_penalty={constants['red_black_penalty']:.4g}, "
          f"kernel_launch_overhead={constants['kernel_launch_overhead'] * 1e6:.4g} us, "
          f"fusion_factor={constants['fusion_factor']:.4g}, "
          f"single_sweep_fusion={constants['single_sweep_fusion']:.4g}, "
          f"intergrid_factor={constants['intergrid_factor']:.4g}, log-rmse={log_rmse:.3f}")
    rows = []
    outside = []
    for name, expr, t, wall in measured:
        p = model_time(expr, **constants)
        ratio = p / t
        if not 1 / GATE <= ratio <= GATE:
            outside.append(name)
        print(f"  {name}: measured {1e6 * t:.1f} us, predicted {1e6 * p:.1f} us, "
              f"ratio {ratio:.3f}, wall/device {wall / t if wall else float('nan'):.2f}")
        rows.append({"case": name, "measured_s": t, "predicted_s": p, "wall_s": wall})
    out = {
        "device": device,
        "red_black_penalty": constants["red_black_penalty"],
        "kernel_launch_overhead_s": constants["kernel_launch_overhead"],
        "fusion_factor": constants["fusion_factor"],
        "single_sweep_fusion": constants["single_sweep_fusion"],
        "intergrid_factor": constants["intergrid_factor"],
        "log_rmse": log_rmse,
        "cases": rows,
    }
    with open(PATH, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"\nwrote {PATH}")
    print("Set the *_H100 constants in evostencils_torch/models/roofline.py to these values.")
    if outside:
        print(f"outside the 1/{GATE}-{GATE} gate: {', '.join(outside)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
