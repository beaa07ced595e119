"""Drive the PyTorch/CUDA port's fitness-evaluation path once on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  It imports nothing of JAX and
fails loudly: without CUDA it exits non-zero before printing any result,
and any failed check makes it exit non-zero.  Phases, each printing one
JSON line:

1. device: the card, `nvidia-smi`'s name and power limit, and the time
   nvcc took to build the kernel library from csrc/.
2. kernel: the red-black sweep kernel against its plain torch version on
   the card, at every grid size the main path gives it (31² to 1023²) and a
   ragged 161×96, with a stencil for every instance of the kernel (the
   5-point and the 9-point stencil, a radius-1 stencil of another pattern,
   a radius-2 stencil and an asymmetric radius-4 one), ω = 1.15,
   max|Δ| < 5e-5; median CUDA-event times of
   the kernel and of the plain version at 511² and 1023², as device time
   (`ms`, calls queued back to back) and as the span of one call with the
   host's launch overhead (`call_ms`).
3. levels: the kernel's device time on the 5-point stencil at every level
   of the main path (63² to 1023²), L2 warm as the main path finds it
   (evostencils_torch/measure.py, as for the kernel phase), beside the
   level's bound (12 bytes a point over 3.35 TB/s) and the
   share of that bound it reaches, and the launch floor: the device time
   of an empty kernel queued the same way.
4. main path: the 2D Poisson bench problem (levels 5-9, 511² finest, f32),
   16 seeded depth-4 grammar trees and the stored tuned champion, then the
   champion in the 1023² configuration of scripts/headline_1024.py (levels
   6-10), through TorchProgramGenerator.generate_and_evaluate on the card,
   with the kernel's launch counts by grid size; then the 511² champion
   again on the CPU through the same port, which must agree (ρ within 2 %,
   iterations within ±1).
5. evolve: the evolution entry point, scripts/torch_optimize.py, in this
   process on the card: 2D Poisson levels 5-9 (511²) in f32, NSGA-II,
   μ = λ = 8, initial factor 4, 2 generations, 3 evaluation samples, a
   fixed seed and --tune, its artifacts under chiprun_out/evolve/.  It
   reports the evaluations (and how many went through same-structure
   groups), the wall time and evaluations per hour, the VM hit rate, the
   best ρ and its iterations, the tuner's ρ before and after, and the
   kernel's launches by grid size during the run.  Checks: a finite
   fitness and best ρ < 1; the best-ρ individual re-evaluated gives its
   recorded ρ within 2 %; `generate_and_evaluate_group` on the champion
   with 4 ω variants agrees with each member's own evaluation (ρ within
   2 %, iterations within ±1) with one shared time per iteration; the
   kernel launched.
6. profile: one more evaluation of the 511² champion under
   torch.profiler: wall time, device busy time and idle share, device
   operations, the kernel's share; the full table by kernel goes to
   chiprun_out/profile_champion_eval.txt.

Before the last line it prints the kernels as one JSON object and the card's
`nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.transformations import collect_cycles
from evostencils_torch.measure import LEVELS, bound_ms, median_device_ms
from evostencils_torch.ops import _build, rb_sweep
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from scripts import torch_optimize

ROOT = os.path.dirname(os.path.abspath(__file__))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")
KERNEL_SOURCE = "evostencils_torch/csrc/rb_sweep.cu"
TOLERANCE = 5e-5  # as tests/test_pallas.py holds the Pallas kernels
OMEGA = 1.15
STENCILS = {
    "5-point": constant.Stencil(
        (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0))
    ),
    "9-point": constant.Stencil(
        (((0, 0), 8.0 / 3), ((1, 0), -1 / 3), ((-1, 0), -1 / 3), ((0, 1), -1 / 3),
         ((0, -1), -1 / 3), ((1, 1), -1 / 3), ((1, -1), -1 / 3), ((-1, 1), -1 / 3),
         ((-1, -1), -1 / 3))
    ),
    # Radius 1, neither the 5-point nor the 9-point pattern.
    "skew": constant.Stencil((((0, 0), 2.0), ((1, 1), -0.5), ((-1, 0), -0.25), ((0, -1), -0.25))),
    "radius-2": constant.Stencil(
        (((0, 0), 2.5), ((2, -1), -0.5), ((-2, 1), 0.75), ((0, 2), -0.25), ((1, 0), -0.5))
    ),
    # No symmetry: a sign or axis error in the offsets shows up here.
    "asymmetric": constant.Stencil(
        (((0, 0), 4.0), ((1, 0), -1.5), ((-1, 0), -0.5), ((0, 1), -0.75), ((0, -2), -0.25),
         ((2, -1), 0.125), ((-4, 3), -0.0625), ((3, 4), 0.1))
    ),
}
# Every level of the main path (31²-511² in the bench configuration, 1023²
# in the headline one) and the ragged case of the row-blocked kernel's
# tests in tests/test_pallas.py.
CHECKED = [(31, 31), (63, 63), (127, 127), (255, 255), (511, 511), (1023, 1023), (161, 96)]
# The Pallas call each grid size went to on the TPU (whole-array up to
# 512² cells, row-blocked above: pallas_kernels.py:273), with its timed size.
WHOLE_ARRAY_CELLS = 512 * 512
ROLES = {
    "whole_array": ("evostencils_tpu/ops/pallas_kernels.py:238", (511, 511)),  # _rb_sweep_call
    "row_blocked": ("evostencils_tpu/ops/pallas_kernels.py:180", (1023, 1023)),  # _rb_blocked_call
}


def role(shape) -> str:
    return "whole_array" if shape[0] * shape[1] <= WHOLE_ARRAY_CELLS else "row_blocked"


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def median_call_ms(fn, repeats: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event span of one fn() call as the main path makes it:
    the host's launch overhead is inside the span."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    record = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_library": _build.library_path().name,
        "nvcc_s": _build.build_seconds,
        "build_and_load_s": time.perf_counter() - t0,
        "ptxas": [line.strip() for line in _build.build_log.splitlines() if "ptxas info" in line],
    }
    emit(record)
    return record


def phase_kernel(failures: list) -> dict:
    """Kernel vs plain version on the card; returns max|Δ| and times by size."""
    rng = np.random.default_rng(3)
    omega = torch.full((1,), OMEGA, dtype=torch.float32, device="cuda")
    by_shape = {}
    for shape in CHECKED:
        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        entry = {"shape": list(shape), "max_abs_err": {}}
        for name, stencil in STENCILS.items():
            out = rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil)
            ref = rb_sweep.rb_sweep_reference(u, f, omega, stencil)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            entry["max_abs_err"][name] = err
            if not err < TOLERANCE:
                failures.append(f"kernel {name} {shape}: max|Δ| {err} >= {TOLERANCE}")
        if shape in (timed for _, timed in ROLES.values()):
            stencil = STENCILS["5-point"]
            def kernel():
                return rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil)

            def plain():
                return rb_sweep.rb_sweep_reference(u, f, omega, stencil)

            entry["ms"] = median_device_ms(kernel)
            entry["plain_ms"] = median_device_ms(plain)
            entry["call_ms"] = median_call_ms(kernel)
            entry["plain_call_ms"] = median_call_ms(plain)
            entry["bound_ms"] = bound_ms(shape)
            entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
        by_shape[shape] = entry
        emit({"phase": "kernel", **entry})
    return by_shape


def phase_levels() -> list:
    """The kernel's device time at each level of the main path, with the
    5-point stencil, beside the level's bound and the launch floor."""
    emit({"phase": "levels", "launch_floor_ms": median_device_ms(lambda: torch.cuda._sleep(0))})
    rng = np.random.default_rng(4)
    omega = torch.full((1,), OMEGA, dtype=torch.float32, device="cuda")
    stencil = STENCILS["5-point"]
    levels = []
    for shape in LEVELS:
        u, f = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
                for _ in range(2))
        ms = median_device_ms(
            lambda: rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil))
        level = {"shape": list(shape), "ms": ms, "bound_ms": bound_ms(shape),
                 "share_of_bound": bound_ms(shape) / ms}
        levels.append(level)
        emit({"phase": "levels", **level})
    return levels


def bench_pset(problem):
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=4, maximum_local_system_size=8,
    )
    return pset


def load_champion(pset):
    tree_string, omegas = parse_champion_file(CHAMPION)
    champion = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
    return champion, apply_stored_omegas(champion, omegas, label="chip_smoke champion")


def check_results(failures: list, label: str, results) -> None:
    """No NaN anywhere, and no ρ of ∞: the poison of a device fault or of
    a cycle that failed to build (a diverging cycle has a finite ρ ≥ 1)."""
    for index, (t, rho, iterations) in enumerate(results):
        if any(math.isnan(v) for v in (t, rho, iterations)):
            failures.append(f"{label} {index}: a NaN fitness value")
        if math.isinf(rho):
            failures.append(f"{label} {index}: ρ is ∞ (device fault or build error)")


def phase_main_path(failures: list) -> tuple:
    problem = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
    pset = bench_pset(problem)
    generator = TorchProgramGenerator(
        problem, dtype=torch.float32, iteration_limit=500, device="cuda")
    rng = random.Random(20260816)
    individuals = [gp.gen_grow(pset, 2, 16, rng=rng) for _ in range(16)]
    warm = gp.gen_grow(pset, 2, 10, rng=rng)
    generator.generate_and_evaluate(gp.compile_tree(warm, pset)[0], evaluation_samples=1)
    torch.cuda.synchronize()

    champion, omegas_applied = load_champion(pset)
    # The headline configuration: the same champion on levels 6-10.
    headline = TorchProgramGenerator(
        poisson_2d(min_level=6, max_level=10, dtype=torch.float32),
        dtype=torch.float32, iteration_limit=500, device="cuda")
    champion_1023, omegas_applied_1023 = load_champion(bench_pset(headline.problem))

    rb_sweep.launches.clear()
    start = time.perf_counter()
    results = []
    for individual in individuals:
        expr = gp.compile_tree(individual, pset)[0]
        results.append(generator.generate_and_evaluate(expr, evaluation_samples=3))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    t0 = time.perf_counter()
    champ_t, champ_rho, champ_iters = generator.generate_and_evaluate(
        champion, evaluation_samples=3)
    torch.cuda.synchronize()
    champ_eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result_1023 = headline.generate_and_evaluate(champion_1023, evaluation_samples=3)
    torch.cuda.synchronize()
    eval_1023_s = time.perf_counter() - t0
    by_shape = dict(rb_sweep.launches)
    launches_by_role = {name: 0 for name in ROLES}
    for shape, count in by_shape.items():
        launches_by_role[role(shape)] += count

    record = {
        "phase": "main_path",
        "n_individuals": len(individuals),
        "elapsed_s": elapsed,
        "evals_per_hour": len(individuals) / elapsed * 3600.0,
        "converged": sum(1 for _, rho, _ in results if rho < 1.0),
        "best_rho": min(rho for _, rho, _ in results),
        "results": [list(r) for r in results],
        "vm_stats": generator.vm_stats(),
        "champion": {
            "rho": champ_rho, "iterations": champ_iters, "time_to_target_ms": champ_t,
            "eval_s": champ_eval_s, "omegas_applied": bool(omegas_applied),
        },
        "champion_1023": {
            "rho": result_1023[1], "iterations": result_1023[2],
            "time_to_target_ms": result_1023[0], "eval_s": eval_1023_s,
            "omegas_applied": bool(omegas_applied_1023),
        },
        "rb_sweep_launches": sum(by_shape.values()),
        "rb_sweep_launches_by_shape": {f"{r}x{c}": n for (r, c), n in sorted(by_shape.items())},
    }
    emit(record)

    check_results(failures, "tree", results)
    check_results(failures, "champion", [(champ_t, champ_rho, champ_iters), result_1023])
    for name, count in launches_by_role.items():
        if count == 0:
            failures.append(f"main path: the kernel never ran in its {name} role")
    if not champ_rho < 0.2:
        failures.append(f"main path: champion rho {champ_rho} >= 0.2")
    if not result_1023[1] < 1.0:
        failures.append(f"main path: champion at 1023² does not converge (rho {result_1023[1]})")
    if not (omegas_applied and omegas_applied_1023):
        failures.append("main path: the champion's stored omegas were not applied")

    cpu = TorchProgramGenerator(
        poisson_2d(min_level=5, max_level=9, dtype=torch.float32),
        dtype=torch.float32, iteration_limit=500, device="cpu")
    t0 = time.perf_counter()
    _, cpu_rho, cpu_iters = cpu.generate_and_evaluate(champion, evaluation_samples=1)
    emit({"phase": "champion_on_cpu", "rho": cpu_rho, "iterations": cpu_iters,
          "eval_s": time.perf_counter() - t0})
    if not abs(cpu_rho - champ_rho) <= 0.02 * champ_rho:
        failures.append(f"champion: CPU rho {cpu_rho} vs GPU {champ_rho} beyond 2 %")
    if not abs(cpu_iters - champ_iters) <= 1:
        failures.append(f"champion: CPU iterations {cpu_iters} vs GPU {champ_iters}")
    return launches_by_role, generator, champion


EVOLVE_ARGS = [
    "--problem", "poisson2d", "--method", "nsga2", "--mu", "8", "--lambda", "8",
    "--generations", "2", "--min-level", "5", "--max-level", "9", "--dtype", "float32",
    "--evaluation-samples", "3", "--seed", "3", "--tune",
    "--output", os.path.join(ROOT, "chiprun_out", "evolve"),
]


def champion_variants(pset, n: int) -> list:
    """The champion with its stored ω and n - 1 seeded perturbations of
    them inside [0.1, 1.9]: one same-structure group."""
    stored = parse_champion_file(CHAMPION)[1]
    rng = np.random.default_rng(13)
    members = []
    for i in range(n):
        champion, _ = load_champion(pset)
        omegas = stored if i == 0 else np.clip(
            np.asarray(stored) * rng.uniform(0.85, 1.1, len(stored)), 0.1, 1.9)
        for cycle, omega in zip(collect_cycles(champion), omegas):
            cycle.relaxation_factor = float(omega)
        members.append(champion)
    return members


def phase_evolve(failures: list) -> dict:
    """Evolution through scripts/torch_optimize.py; returns the kernel's
    launches by grid shape during the run."""
    start = time.perf_counter()
    rb_sweep.launches.clear()
    result = torch_optimize.run(EVOLVE_ARGS)
    torch.cuda.synchronize()
    by_shape = dict(rb_sweep.launches)
    optimizer, generator = result.optimizer, result.generator
    evaluations = optimizer._total_number_of_evaluations

    individuals = [ind for hof in result.halls_of_fame for ind in hof]
    converged = [ind for ind in individuals if ind.fitness_values[1] < optimizer.infinity]
    best = min(converged, key=lambda ind: ind.fitness_values[0]) if converged else None
    record = {
        "phase": "evolve",
        "args": " ".join(EVOLVE_ARGS[:-2]),
        "evaluations": evaluations,
        "group_members": generator.group_members,
        "groups": generator.groups,
        "evolution_s": result.evolution_s,
        "evals_per_hour": evaluations / result.evolution_s * 3600.0,
        "vm_stats": generator.vm_stats(),
        "converged_in_hall_of_fame": len(converged),
    }
    if best is not None:
        expr = optimizer.compile_individual(best)[0]
        _, rho, iterations = generator.generate_and_evaluate(expr, evaluation_samples=3)
        record["best_rho"] = {"recorded": best.fitness_values[0], "reevaluated": rho,
                              "iterations": iterations}
        if not best.fitness_values[0] < 1.0:
            failures.append(f"evolve: best rho {best.fitness_values[0]} >= 1")
        if not abs(rho - best.fitness_values[0]) <= 0.02 * best.fitness_values[0]:
            failures.append(f"evolve: best-rho individual re-evaluated at {rho}, "
                            f"recorded {best.fitness_values[0]}")
    else:
        failures.append("evolve: no individual with a finite fitness")
    if result.tuning is not None:
        record["tuning"] = {"rho_before": result.tuning[0], "rho_after": result.tuning[1]}
    else:
        failures.append("evolve: --tune did not run")

    # The group path on the champion: 4 ω variants against their own
    # single evaluations, with one shared time per iteration.
    members = champion_variants(bench_pset(generator.problem), 4)
    group = generator.generate_and_evaluate_group(members, evaluation_samples=3)
    singles = [generator.generate_and_evaluate(e, evaluation_samples=3) for e in members]
    record["group_check"] = {"group": [list(r) for r in group],
                             "single": [list(r) for r in singles]}
    per_iteration = [t / it for t, _, it in group if math.isfinite(t) and t < optimizer.infinity]
    if len(per_iteration) != len(members) or max(per_iteration) - min(per_iteration) > (
            1e-9 * max(per_iteration)):
        failures.append(f"evolve: group times per iteration {per_iteration} are not one shared time")
    for (_, rho_g, it_g), (_, rho_s, it_s) in zip(group, singles):
        if not (abs(rho_g - rho_s) <= 0.02 * rho_s and abs(it_g - it_s) <= 1):
            failures.append(f"evolve: group member rho {rho_g} in {it_g} vs single "
                            f"{rho_s} in {it_s}")
    record["rb_sweep_launches"] = sum(by_shape.values())
    record["rb_sweep_launches_by_shape"] = {
        f"{r}x{c}": n for (r, c), n in sorted(by_shape.items())}
    if not by_shape:
        failures.append("evolve: the kernel never ran")
    record["phase_s"] = time.perf_counter() - start
    emit(record)
    return by_shape


def phase_profile(generator, champion) -> None:
    """One evaluation of the champion under torch.profiler; the idle share
    is against the same evaluation's wall time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    def evaluate():
        generator.generate_and_evaluate(champion, evaluation_samples=3)
        torch.cuda.synchronize()

    evaluate()
    t0 = time.perf_counter()
    evaluate()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate()
        profiled_wall_s = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    sweep = [e for e in device if "rb_sweep_kernel" in e.name]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_champion_eval.txt"), "w") as table:
        table.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    emit({
        "phase": "profile",
        "wall_ms": wall_s * 1e3,
        "profiled_wall_ms": profiled_wall_s * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "device_ops": len(device),
        "rb_sweep_kernel": {
            "launches": len(sweep),
            "busy_ms": sum(e.time_range.elapsed_us() for e in sweep) / 1e3,
        },
    })


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    failures = []
    device = phase_device()
    kernel = phase_kernel(failures)
    phase_levels()
    launches_by_role, generator, champion = phase_main_path(failures)
    evolve_launches = phase_evolve(failures)
    phase_profile(generator, champion)
    if failures:
        for failure in failures:
            print(f"chip_smoke FAILED: {failure}", file=sys.stderr)
        return 1
    kernels = []
    for name, (replaces, timed) in ROLES.items():
        kernels.append({
            "name": f"rb_sweep_f32 ({name})", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "shape": list(timed),
            "launches": launches_by_role[name],
            "evolve_launches": sum(n for shape, n in evolve_launches.items()
                                   if role(shape) == name),
            "max_abs_err": max(e for s in CHECKED if role(s) == name
                               for e in kernel[s]["max_abs_err"].values()),
            "ms": kernel[timed]["ms"], "plain_ms": kernel[timed]["plain_ms"],
            "bound_ms": kernel[timed]["bound_ms"], "bound_by": "bytes",
            "share_of_bound": kernel[timed]["share_of_bound"],
            # No single PyTorch call computes a red-black collective-Jacobi step.
            "library_ms": None,
        })
    emit({"kernels": kernels})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
