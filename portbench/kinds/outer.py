"""Helmholtz fitness evaluations: the cycle as the right preconditioner of
BiCGStab on the indefinite operator, counted in outer iterations to the
configuration's target (`generate_and_evaluate(...,
global_variable_values={"k": k})` with one rung of the k-ladder).

Set-up builds the generator and evaluates the mix's warm-up candidates
once, which captures the interpreter's branches and the glue every
candidate shares.  The window runs the mix's cyclic order of candidates
from a seeded offset.  The check redoes the probe, the staged outer solve
and its ρ of a seeded sample of the candidates the window evaluated, in
complex128 with the plain reference.
"""

from __future__ import annotations

import math
import time

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.utils.champions import apply_stored_omegas
from portbench.kinds import common
from portbench.reference.cycle import Cycle
from portbench.reference.fitness import outer_fitness
from portbench.reference.hierarchy import Level, dirac_pulse


def describe(records) -> str:
    """Each candidate's outer iterations and evaluations in the window."""
    seen = {}
    for r in records:
        if "candidate" in r:
            it, count = seen.get(r["candidate"], (r["it"], 0))
            seen[r["candidate"]] = (it, count + 1)
    return "candidate: (outer iterations, evaluations) " + str(dict(sorted(seen.items())))


def build_problem(config: dict):
    problem = helmholtz_2d(config["min_level"], config["max_level"], k=config["k"],
                           shift=complex(*config["shift"]), boundary=config["boundary"],
                           dtype=common.DTYPES[config["dtype"]])
    spec = problem.outer_solver
    if (spec["target_reduction"], spec["max_iterations"]) != (config["outer_target"],
                                                              config["outer_cap"]):
        raise ValueError(f"the problem's outer solve {spec} is not the configuration's")
    return problem


class Work:
    def __init__(self, config, traffic, seed, device, spans):
        self.spans = spans
        self.samples = config["evaluation_samples"]
        self.k = {"k": config["k"]}
        problem = build_problem(config)
        pset, _ = common.primitive_set(problem, config)
        self.generator = TorchProgramGenerator(
            problem, dtype=common.DTYPES[config["dtype"]], device=device,
            ladder_rungs=config["ladder_rungs"])
        self.candidates = []
        for name in traffic["candidates"]:
            text, omegas = common.read_champion(common.data_path(name, config))
            expr = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
            if omegas is not None and not apply_stored_omegas(expr, omegas, label=name):
                raise ValueError(f"{name}: the stored ω do not fit its tree")
            self.candidates.append(expr)
        self.order = common.seeded_order(traffic["order"], seed, 5)
        for index in traffic["warmup"]:
            self.generator.generate_and_evaluate(
                self.candidates[index], evaluation_samples=1, global_variable_values=self.k)

    def request(self, i: int) -> dict:
        index = self.order[i % len(self.order)]
        with self.spans.enter("outer.evaluate"):
            t, rho, iterations = self.generator.generate_and_evaluate(
                self.candidates[index], evaluation_samples=self.samples,
                global_variable_values=self.k)
        return {"candidate": index, "t": float(t), "rho": float(rho), "it": float(iterations),
                "probe": dict(self.generator.last_outer_solve or {}),
                "failed": self.generator._consecutive_device_failures > 0}

    def counters(self) -> dict:
        return common.counters()

    def release(self) -> dict:
        del self.generator, self.candidates
        return {}


def reference_fitness(path: str, config: dict, device, dtype=torch.complex128):
    """(class, ρ, outer iterations) of one candidate by the plain reference."""
    text, omegas = common.read_champion(path)
    k2 = config["k"] ** 2
    level = config["max_level"]
    cycle = Cycle(text, level, shift_k2=complex(*config["shift"]) * k2, omegas=omegas,
                  dtype=dtype, device=device)
    outer = Level(level, shift_k2=k2)
    f = dirac_pulse(level, dtype, device)
    return outer_fitness(outer.apply, cycle, f, config["outer_target"], config["outer_cap"],
                         probe=config["probe_iterations"])


def gaps(record: dict, reference) -> tuple:
    """(iteration gap, ρ gap), relative to the reference; 1 where one side
    reaches the target and the other does not."""
    ref_class, ref_rho, ref_it = reference
    converged = record["t"] < 1e50 and math.isfinite(record["t"])
    if converged != (ref_class == "converged"):
        return 1.0, 1.0
    if not math.isfinite(ref_rho) or ref_rho >= 1e50:
        return (0.0, 0.0) if record["rho"] >= 1e50 else (1.0, 1.0)
    return abs(record["it"] - ref_it) / ref_it, abs(record["rho"] - ref_rho) / ref_rho


def check(config, traffic, seed, records, device, limits, kept) -> dict:
    done = [r for r in records if "candidate" in r and not r.get("failed")]
    iteration_gap = rho_gap = 0.0 if done else math.inf
    chosen = common.sample(sorted({r["candidate"] for r in done}), traffic["check_candidates"],
                           seed, 6)
    for index in chosen:
        path = common.data_path(traffic["candidates"][index], config)
        reference = reference_fitness(path, config, device)
        for record in (r for r in done if r["candidate"] == index):
            g_it, g_rho = gaps(record, reference)
            iteration_gap, rho_gap = max(iteration_gap, g_it), max(rho_gap, g_rho)
    return {"outer_iteration_gap": {"value": iteration_gap,
                                    "limit": limits["outer_iteration_gap"]},
            "outer_rho_gap": {"value": rho_gap, "limit": limits["outer_rho_gap"]}}


def control(config, traffic, seeds, device, dtype=torch.complex64):
    """The readings that set the limits, at the cell's size: every candidate
    by the program (one timing sample), by the complex128 reference and by
    the reference in `dtype` put in the program's place."""
    problem = build_problem(config)
    pset, _ = common.primitive_set(problem, config)
    generator = TorchProgramGenerator(problem, dtype=common.DTYPES[config["dtype"]],
                                      device=device, ladder_rungs=config["ladder_rungs"])
    k = {"k": config["k"]}
    for index, name in enumerate(traffic["candidates"]):
        path = common.data_path(name, config)
        text, omegas = common.read_champion(path)
        expr = gp.compile_tree(gp.parse_tree(text, pset), pset)[0]
        if omegas is not None:
            apply_stored_omegas(expr, omegas, label=name)
        t0 = time.perf_counter()
        t, rho, it = generator.generate_and_evaluate(
            expr, evaluation_samples=config["evaluation_samples"], global_variable_values=k)
        seconds = time.perf_counter() - t0
        program = {"t": float(t), "rho": float(rho), "it": float(it)}
        reference = reference_fitness(path, config, device)
        low = reference_fitness(path, config, device, dtype)
        as_record = {"t": 1.0 if low[0] == "converged" else 1e100, "rho": low[1], "it": low[2]}
        yield {"candidate": index, "name": name, "eval_s": seconds, "program": program,
               "probe": dict(generator.last_outer_solve or {}),
               "reference": list(reference), "control": list(low),
               "program_gaps": gaps(program, reference), "control_gaps": gaps(as_record, reference)}
