"""Same-structure groups of grammar trees, as the optimizer evaluates the
offspring of a generation that differ only in their relaxation factors
(`Optimizer._evaluate_population`): each group's trees are `compile_tree`d
and scored by one `TorchProgramGenerator.generate_and_evaluate_group` call
(3 timing samples), which runs their power iterations as one batched loop.

Set-up builds the generator and evaluates every group of the mix once, so
every bucket's interpreter, lowered structure and glue the window uses is
captured before it.  The window runs the mix's cyclic order of groups from
a seeded offset.  `request(i)` evaluates the next group when the records of
the last one are used up, then returns one record a member, so the window
counts member evaluations and ends on a member of the group that crosses
it.

`counters()` holds, besides the search cell's counts, the members handed
to the program so far ("members_evaluated") and the generator's
`group_stats()` under "group" (absent where the program has none).

The check: the search cell's ρ and iteration gaps against the float64
reference, over a seeded sample of the window's members, each by its own
tree string (kinds/search.gaps).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.problems.poisson import poisson_2d
from portbench.kinds import common, search

INFINITY = 1e100


def read_groups(path: str) -> Tuple[Dict[str, str], List[List[str]]]:
    """({member id: tree string}, member ids by group) of a group file:
    one line a member, `g<group>.m<member> <tree>`."""
    trees, groups = {}, {}
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            member, text = line.split(None, 1)
            trees[member] = text.strip()
            groups.setdefault(int(member[1:member.index(".")]), []).append(member)
    return trees, [groups[g] for g in sorted(groups)]


def group_stats(generator):
    """The generator's group counters, or None where the program has none."""
    stats = getattr(generator, "group_stats", None)
    return None if stats is None else stats()


class Work:
    def __init__(self, config, traffic, seed, device, spans):
        self.spans = spans
        self.samples = config["evaluation_samples"]
        dtype = common.DTYPES[config["dtype"]]
        problem = poisson_2d(config["min_level"], config["max_level"], dtype=dtype)
        self.pset, _ = common.primitive_set(problem, config)
        self.generator = TorchProgramGenerator(
            problem, dtype=dtype, iteration_limit=config["iteration_limit"], device=device)
        texts, self.groups = read_groups(common.data_path(traffic["groups"], config))
        self.trees = {m: gp.parse_tree(texts[m], self.pset) for g in self.groups for m in g}
        self.order = common.seeded_order(traffic["order"], seed, 1)
        self.next_group = 0
        self.members_evaluated = 0
        self.queue: List[dict] = []
        for g in traffic["order"]:
            self.evaluate(g, samples=1)

    def evaluate(self, g: int, samples: int) -> List[dict]:
        members = self.groups[g]
        self.members_evaluated += len(members)
        with self.spans.enter("groups.compile"):
            exprs = [gp.compile_tree(self.trees[m], self.pset)[0] for m in members]
        with self.spans.enter("groups.evaluate"):
            results = self.generator.generate_and_evaluate_group(
                exprs, infinity=INFINITY, evaluation_samples=samples)
        failed = self.generator._consecutive_device_failures > 0
        return [{"tree": m, "t": float(t), "rho": float(rho), "it": float(it), "failed": failed}
                for m, (t, rho, it) in zip(members, results)]

    def request(self, i: int) -> dict:
        if not self.queue:
            g = self.order[self.next_group % len(self.order)]
            self.next_group += 1
            self.queue = self.evaluate(g, self.samples)
        return self.queue.pop(0)

    def counters(self) -> dict:
        out = common.counters()
        out["members_evaluated"] = self.members_evaluated
        stats = group_stats(self.generator)
        if stats is not None:
            out["group"] = stats
        return out

    def release(self) -> dict:
        del self.generator, self.trees
        return {}


def check(config, traffic, seed, records, device, limits, kept) -> dict:
    texts, _ = read_groups(common.data_path(traffic["groups"], config))
    done = [r for r in records if "tree" in r and not r.get("failed")]
    members = common.sample(sorted({r["tree"] for r in done}), traffic["check_members"], seed, 2)
    rho_gap = iteration_gap = 0.0
    for member in members:
        reference = search.reference_fitness(texts[member], config, device)
        for record in (r for r in done if r["tree"] == member):
            g_rho, g_it = search.gaps(record, reference)
            rho_gap, iteration_gap = max(rho_gap, g_rho), max(iteration_gap, g_it)
    if not members:
        rho_gap = iteration_gap = math.inf
    return {"rho_gap": {"value": rho_gap, "limit": limits["rho_gap"]},
            "iteration_gap": {"value": iteration_gap, "limit": limits["iteration_gap"]}}


def control(config, traffic, seeds, device, dtype=torch.bfloat16):
    """The readings that set the limits, at the cell's size: every member
    of the mix by the program (each group once with one timing sample, then
    timed with the configuration's), by the float64 reference and by the
    reference in `dtype` put in the program's place; then each seed's sample
    as the check draws it, with the worst gaps of both."""
    problem = poisson_2d(config["min_level"], config["max_level"],
                         dtype=common.DTYPES[config["dtype"]])
    pset, _ = common.primitive_set(problem, config)
    generator = TorchProgramGenerator(problem, dtype=common.DTYPES[config["dtype"]],
                                      iteration_limit=config["iteration_limit"], device=device)
    texts, groups = read_groups(common.data_path(traffic["groups"], config))
    rows = {}
    for g in traffic["order"]:
        exprs = [gp.compile_tree(gp.parse_tree(texts[m], pset), pset)[0] for m in groups[g]]
        generator.generate_and_evaluate_group(exprs, infinity=INFINITY, evaluation_samples=1)
        t0 = time.perf_counter()
        results = generator.generate_and_evaluate_group(
            exprs, infinity=INFINITY, evaluation_samples=config["evaluation_samples"])
        seconds = time.perf_counter() - t0
        for m, (t, rho, it) in zip(groups[g], results):
            program = {"t": float(t), "rho": float(rho), "it": float(it)}
            reference = search.reference_fitness(texts[m], config, device)
            low = search.reference_fitness(texts[m], config, device, dtype)
            as_record = {"t": 1.0 if low[0] == "converged" else INFINITY, "rho": low[1],
                         "it": low[2]}
            rows[m] = {"tree": m, "group_s": seconds, "program": program,
                       "reference": list(reference), "control": list(low),
                       "program_gaps": search.gaps(program, reference),
                       "control_gaps": search.gaps(as_record, reference)}
            yield rows[m]
    yield {"group_stats": group_stats(generator)}
    for seed in seeds:
        members = common.sample(sorted(rows), traffic["check_members"], seed, 2)
        yield {"seed": seed, "members": members,
               "program": [max(rows[m]["program_gaps"][k] for m in members) for k in (0, 1)],
               "control": [max(rows[m]["control_gaps"][k] for m in members) for k in (0, 1)]}
