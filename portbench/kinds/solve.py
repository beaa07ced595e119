"""Back-to-back solves with a stored evolved solver, as its user runs it:
the champion deployed as the predicted staged solver
(`staged_solver_for_expression(..., rho=ρ, calibrate_floor=True)`, float32
stages, float64 restarts on the device, the host's float64 verdict) to the
configuration's relative-residual target.

Set-up makes the right-hand side from the mix's `rhs_seed` (standard
normals rounded to float32, the problem's right-hand side: the solver's
host verdict is bound to the right-hand side it was built with, and its
stage lengths follow it), measures ρ with the fitness
evaluation, builds and captures the solver and runs it a few times.  The
benchmark's own span times each host verdict: the solver gets a thin
wrapper of the generator whose `_host_residual` delegates the call and
keeps the iterate it judged.  The check recomputes, in extended precision
with the plain reference's operator, the relative residual of a seeded
sample of the window's solutions.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from evostencils_torch.backend.device_solve import staged_solver_for_expression
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import gp
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas
from portbench import stats
from portbench.kinds import common
from portbench.reference.cycle import Cycle
from portbench.reference.residual import relative_residual


def gaussian_rhs(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)


class _TimedVerdict:
    """The generator as the staged solver sees it, with the host verdict
    timed by the benchmark's span and its last iterate kept."""

    def __init__(self, generator, spans):
        self.generator, self.spans = generator, spans
        self.last_u = None

    def _host_residual(self, operator, u_fields, f_fields):
        with self.spans.enter("solve.verdict"):
            out = self.generator._host_residual(operator, u_fields, f_fields)
        self.last_u = u_fields
        return out


class Work:
    def __init__(self, config, traffic, seed, device, spans):
        self.spans = spans
        dtype = common.DTYPES[config["dtype"]]
        problem = poisson_2d(config["min_level"], config["max_level"], dtype=dtype)
        n = 2 ** config["max_level"] - 1
        rhs = gaussian_rhs(traffic["rhs_seed"], n)
        problem.rhs_functions = [lambda *coordinates: rhs]
        pset, terminals = common.primitive_set(problem, config)
        text, omegas = common.read_champion(common.data_path(traffic["champion"], config))
        expr = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
        if omegas is not None and not apply_stored_omegas(expr, omegas):
            raise ValueError("the champion's stored ω do not fit its tree")
        generator = TorchProgramGenerator(problem, dtype=dtype,
                                          iteration_limit=config["iteration_limit"],
                                          device=device)
        _, rho, _ = generator.generate_and_evaluate(expr, evaluation_samples=1)
        self.rho = float(rho)
        self.verdict = _TimedVerdict(generator, spans)
        self.solve, self.f64 = staged_solver_for_expression(
            CycleLowering(dtype, device), expr, terminals[0].operator, problem, self.verdict,
            fused=True, lowering64=CycleLowering(torch.float64, device, use_kernels=False),
            rho=self.rho, calibrate_floor=True, target=config["solve_target"])
        self.f32 = tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                         for x in self.f64)
        for _ in range(traffic["warmup_solves"]):
            self.solve(self.f32, self.f64)
        print(f"solve: rho {self.rho!r}, measured floor {self.solve.measured_floor!r}",
              file=sys.stderr)
        # A seeded reservoir of the window's solutions for the check.
        self.keep = traffic["check_solves"]
        self.kept = []
        self.rng = np.random.default_rng([seed, 4])
        self.generator = generator

    def request(self, i: int) -> dict:
        t0 = time.perf_counter()
        with self.spans.enter("solve.solve"):
            cycles, rel, stages = self.solve(self.f32, self.f64)
        record = {"ms": 1e3 * (time.perf_counter() - t0), "cycles": int(cycles),
                  "rel": float(rel), "stages": int(stages)}
        if len(self.kept) < self.keep:
            self.kept.append((i, self.verdict.last_u))
        else:
            j = int(self.rng.integers(i + 1))
            if j < self.keep:
                self.kept[j] = (i, self.verdict.last_u)
        record["solution"] = i
        return record

    def counters(self) -> dict:
        return common.counters()

    def release(self) -> dict:
        kept = [(i, tuple(np.asarray(x, np.float64) for x in u)) for i, u in self.kept]
        del self.solve, self.verdict, self.generator
        return {"solutions": kept}


def describe(records) -> str:
    """How many solves took how many cycles and stages, and the spread of
    their times."""
    counts = collections.Counter((r["cycles"], r["stages"]) for r in records if "cycles" in r)
    ms = [r["ms"] for r in records if "ms" in r]
    quantiles = [round(stats.percentile(ms, q), 3) for q in (5, 25, 50, 75, 95)] if ms else []
    return (f"(cycles, stages): solves {dict(sorted(counts.items()))}; "
            f"ms at 5/25/50/75/95 %: {quantiles}")


def check(config, traffic, seed, records, device, limits, kept) -> dict:
    n = 2 ** config["max_level"] - 1
    f = gaussian_rhs(traffic["rhs_seed"], n).astype(np.float64)
    worst = max((relative_residual(u[0], f, config["max_level"]) for _, u in kept["solutions"]),
                default=float("inf"))
    return {"residual": {"value": worst, "limit": limits["residual"]}}


def control(config, traffic, seeds, device, dtype=torch.float32, max_cycles=100):
    """The reference's solve in `dtype` put in the program's place: the
    champion's cycle from zero until its residual stops falling, each
    seed's right-hand side, judged as the check judges the program's."""
    level = config["max_level"]
    text, omegas = common.read_champion(common.data_path(traffic["champion"], config))
    for seed in seeds:
        f64 = gaussian_rhs(seed, 2 ** level - 1).astype(np.float64)
        cycle = Cycle(text, level, omegas=omegas, dtype=dtype, device=device)
        f = torch.from_numpy(f64).to(dtype=dtype, device=device)
        u = torch.zeros_like(f)
        best = float("inf")
        for k in range(max_cycles):
            u = cycle(u, f)
            norm = float(torch.linalg.vector_norm(cycle.levels[0].residual(u, f)))
            if not norm < 0.999 * best:
                break
            best = norm
        yield {"seed": seed, "cycles": k + 1,
               "control": relative_residual(u.double().cpu().numpy(), f64, level)}
