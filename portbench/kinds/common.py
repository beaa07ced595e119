"""What the kinds of work share: the configuration's problem and grammar, the
stored champions, the program's counters and the frozen traffic files."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from evostencils_torch.backend import graphs
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ops import rb_sweep

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "complex64": torch.complex64, "complex128": torch.complex128}


def data_path(template: str, config: dict) -> str:
    """A file under portbench/ named by the traffic mix, `{config}` taking
    the configuration's name."""
    return os.path.join(HERE, template.format(config=config["name"]))


def read_champion(path: str) -> Tuple[str, Optional[List[float]]]:
    """(tree string, stored ω or None) of a champion file: the first line
    that is not a comment, and a `# tuned omegas: [...]` line."""
    tree, omegas = None, None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("# tuned omegas:"):
                omegas = json.loads(line.split(":", 1)[1])
            elif line and not line.startswith("#") and tree is None:
                tree = line
    return tree, omegas


def read_pool(path: str) -> List[str]:
    with open(path) as fh:
        return [line.strip() for line in fh if line.strip()]


def primitive_set(problem, config: dict):
    return generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=config["grammar_depth"],
        maximum_local_system_size=config["maximum_local_system_size"])


def counters() -> dict:
    """The program's own counts: its CUDA-graph counters and the sweep
    kernel's launches by shape (replays included)."""
    out = dict(graphs.counters.as_dict())
    out["rb_sweep_launches"] = dict(rb_sweep.launches)
    return out


def seeded_order(order: List[int], seed: int, salt: int) -> List[int]:
    """The traffic's cyclic order started at a seeded offset: every seed runs
    the same sequence of requests, from another place in it."""
    offset = int(np.random.default_rng([seed, salt]).integers(len(order)))
    return list(order[offset:]) + list(order[:offset])


def sample(items: list, k: int, seed: int, salt: int) -> list:
    """k of `items` (all of them when there are no more), drawn from the seed."""
    if len(items) <= k:
        return list(items)
    rng = np.random.default_rng([seed, salt])
    return [items[i] for i in sorted(rng.choice(len(items), size=k, replace=False))]
