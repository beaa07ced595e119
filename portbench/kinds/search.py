"""Fitness evaluations of grammar trees, as the optimizer's serial
dispatcher runs them: each request parses a tree of the frozen pool,
compiles it to the port's IR (`gp.compile_tree`) and evaluates it
(`TorchProgramGenerator.generate_and_evaluate`).

Set-up builds the generator and evaluates every tree of the mix once, so
every VM branch, glue body and lowered structure the window uses is
captured before it.  The window runs the mix's cyclic order from a seeded
offset.  The check redoes the power iteration and the verdict of a seeded
sample of the window's trees in float64 with the plain reference.
"""

from __future__ import annotations

import math
import time

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.problems.poisson import poisson_2d
from portbench.kinds import common
from portbench.reference.cycle import Cycle
from portbench.reference.fitness import cycle_class, power_rate, power_verdict, seeded_error


class Work:
    def __init__(self, config, traffic, seed, device, spans):
        self.spans = spans
        self.samples = config["evaluation_samples"]
        problem = poisson_2d(config["min_level"], config["max_level"],
                             dtype=common.DTYPES[config["dtype"]])
        self.pset, _ = common.primitive_set(problem, config)
        self.generator = TorchProgramGenerator(
            problem, dtype=common.DTYPES[config["dtype"]],
            iteration_limit=config["iteration_limit"], device=device)
        pool = common.read_pool(common.data_path(traffic["pool"], config))
        self.order = common.seeded_order(traffic["order"], seed, 1)
        self.trees = {i: gp.parse_tree(pool[i], self.pset) for i in traffic["order"]}
        for i in traffic["order"]:
            expr = gp.compile_tree(self.trees[i], self.pset)[0]
            self.generator.generate_and_evaluate(expr, evaluation_samples=1)

    def request(self, i: int) -> dict:
        index = self.order[i % len(self.order)]
        with self.spans.enter("search.compile"):
            expr = gp.compile_tree(self.trees[index], self.pset)[0]
        with self.spans.enter("search.evaluate"):
            t, rho, iterations = self.generator.generate_and_evaluate(
                expr, evaluation_samples=self.samples)
        return {"tree": index, "t": float(t), "rho": float(rho), "it": float(iterations),
                "failed": self.generator._consecutive_device_failures > 0}

    def counters(self) -> dict:
        return common.counters()

    def release(self) -> dict:
        del self.generator, self.trees
        return {}


def gaps(record: dict, reference) -> tuple:
    """(ρ gap, iteration gap) of one evaluation against the reference's
    (class, ρ, iterations): relative gaps, 1 where the classes differ, 0
    where both are poisoned."""
    ref_class, ref_rho, ref_it = reference
    if cycle_class(record["t"], record["rho"]) != ref_class:
        return 1.0, 1.0
    if ref_class == "poisoned":
        return 0.0, 0.0
    return (abs(record["rho"] - ref_rho) / abs(ref_rho),
            abs(record["it"] - ref_it) / max(abs(ref_it), 1.0))


def reference_fitness(text: str, config: dict, device, dtype=torch.float64):
    """(class, ρ, iterations) of one tree by the plain reference."""
    n = 2 ** config["max_level"] - 1
    e0 = torch.from_numpy(seeded_error((n, n), config["power_error_seed"])).to(
        dtype=dtype, device=device)
    cycle = Cycle(text, config["max_level"], dtype=dtype, device=device)
    rate, _ = power_rate(cycle, e0)
    return power_verdict(rate, config["residual_target"], config["iteration_limit"])


def check(config, traffic, seed, records, device, limits, kept) -> dict:
    pool = common.read_pool(common.data_path(traffic["pool"], config))
    done = [r for r in records if "tree" in r and not r.get("failed")]
    trees = common.sample(sorted({r["tree"] for r in done}), traffic["check_trees"], seed, 2)
    rho_gap = iteration_gap = 0.0
    for index in trees:
        reference = reference_fitness(pool[index], config, device)
        for record in (r for r in done if r["tree"] == index):
            g_rho, g_it = gaps(record, reference)
            rho_gap, iteration_gap = max(rho_gap, g_rho), max(iteration_gap, g_it)
    if not trees:
        rho_gap = iteration_gap = math.inf
    return {"rho_gap": {"value": rho_gap, "limit": limits["rho_gap"]},
            "iteration_gap": {"value": iteration_gap, "limit": limits["iteration_gap"]}}


def control(config, traffic, seeds, device, dtype=torch.bfloat16):
    """The readings that set the limits, at the cell's size: every tree of
    the mix by the program (one timing sample), by the float64 reference and
    by the reference in `dtype` put in the program's place; then each seed's
    sample as the check draws it, with the worst gaps of both."""
    problem = poisson_2d(config["min_level"], config["max_level"],
                         dtype=common.DTYPES[config["dtype"]])
    pset, _ = common.primitive_set(problem, config)
    generator = TorchProgramGenerator(problem, dtype=common.DTYPES[config["dtype"]],
                                      iteration_limit=config["iteration_limit"], device=device)
    pool = common.read_pool(common.data_path(traffic["pool"], config))
    rows = {}
    for index in traffic["order"]:
        expr = gp.compile_tree(gp.parse_tree(pool[index], pset), pset)[0]
        generator.generate_and_evaluate(expr, evaluation_samples=1)
        t0 = time.perf_counter()
        t, rho, it = generator.generate_and_evaluate(expr, evaluation_samples=config[
            "evaluation_samples"])
        seconds = time.perf_counter() - t0
        program = {"t": float(t), "rho": float(rho), "it": float(it)}
        reference = reference_fitness(pool[index], config, device)
        low = reference_fitness(pool[index], config, device, dtype)
        as_record = {"t": 1.0 if low[0] == "converged" else 1e100, "rho": low[1], "it": low[2]}
        rows[index] = {"tree": index, "eval_s": seconds, "program": program,
                       "reference": list(reference), "control": list(low),
                       "program_gaps": gaps(program, reference),
                       "control_gaps": gaps(as_record, reference)}
        yield rows[index]
    for seed in seeds:
        trees = common.sample(sorted(rows), traffic["check_trees"], seed, 2)
        yield {"seed": seed, "trees": trees,
               "program": [max(rows[i]["program_gaps"][k] for i in trees) for k in (0, 1)],
               "control": [max(rows[i]["control_gaps"][k] for i in trees) for k in (0, 1)]}
