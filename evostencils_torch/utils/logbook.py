"""Observability: per-generation statistics, logbooks, halls of fame.

Self-owned equivalents of deap.tools.{Statistics, MultiStatistics, Logbook,
HallOfFame, ParetoFront} consumed by the reference EA
(reference optimization/program.py:460-463,486-506,659-663,708-713).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np


def dominates(a, b) -> bool:
    """a Pareto-dominates b (minimization).  Local copy to keep utils/
    free of optimization/ imports (optimization.selection re-exports its
    own; both must stay in sync — two lines of math)."""
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


class Statistics:
    def __init__(self, key: Callable):
        self.key = key
        self.functions: Dict[str, Callable] = {}

    def register(self, name: str, fn: Callable):
        self.functions[name] = fn

    def compile(self, population) -> Dict[str, float]:
        values = [self.key(ind) for ind in population]
        finite = [v for v in values if math.isfinite(v)]
        data = np.asarray(finite if finite else [math.inf], dtype=float)
        return {name: float(fn(data)) for name, fn in self.functions.items()}


class MultiStatistics(dict):
    def register(self, name: str, fn: Callable):
        for stats in self.values():
            stats.register(name, fn)

    @property
    def fields(self):
        return list(self.keys())

    def compile(self, population) -> Dict[str, Dict[str, float]]:
        return {key: stats.compile(population) for key, stats in self.items()}


class Logbook:
    """Chronological record of per-generation statistics."""

    def __init__(self):
        self.records: List[Dict] = []
        self.header: List[str] = []

    def record(self, **kwargs):
        self.records.append(kwargs)

    def select(self, *names):
        columns = [[r.get(n) for r in self.records] for n in names]
        return columns if len(columns) > 1 else columns[0]

    @property
    def stream(self) -> str:
        if not self.records:
            return ""
        rec = self.records[-1]
        parts = []
        for key, value in rec.items():
            if isinstance(value, dict):
                inner = " ".join(
                    f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in value.items()
                )
                parts.append(f"{key}[{inner}]")
            elif isinstance(value, float):
                parts.append(f"{key}={value:.4g}")
            else:
                parts.append(f"{key}={value}")
        return "  ".join(parts)


class HallOfFame:
    """Best-k archive, deduplicated by canonical string (minimization)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: List = []

    def update(self, population):
        merged = {str(ind): ind for ind in self.items}
        for ind in population:
            if ind.fitness_values is None:
                continue
            key = str(ind)
            if key not in merged or ind.fitness_values < merged[key].fitness_values:
                merged[key] = ind
        self.items = sorted(merged.values(), key=lambda i: i.fitness_values)[
            : self.maxsize
        ]

    def clear(self):
        self.items = []

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class ParetoFront(HallOfFame):
    """Archive of all non-dominated individuals seen so far."""

    def __init__(self):
        super().__init__(maxsize=2**31)

    def update(self, population):
        merged = {str(ind): ind for ind in self.items}
        for ind in population:
            if ind.fitness_values is None:
                continue
            merged.setdefault(str(ind), ind)
        candidates = list(merged.values())
        front = [
            a
            for a in candidates
            if not any(
                dominates(b.fitness_values, a.fitness_values)
                for b in candidates
                if b is not a
            )
        ]
        self.items = sorted(front, key=lambda i: i.fitness_values)
