"""Selection operators for single- and multi-objective GP (minimization).

Self-owned implementations of the DEAP operators the reference relies on
(deap.tools.selNSGA2 / selTournamentDCD / selNSGA3 / selTournament /
selRandom — consumed at reference optimization/program.py:646-647,689-696,
741-746).  All objectives are minimized; individuals carry their fitness
in `fitness_values` (tuple) as defined by grammar/gp.Tree.
"""

from __future__ import annotations

import math
import random
from typing import List, Sequence

import numpy as np


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """a Pareto-dominates b (minimization)."""
    not_worse = all(x <= y for x, y in zip(a, b))
    strictly_better = any(x < y for x, y in zip(a, b))
    return not_worse and strictly_better


def sort_nondominated(individuals, k=None, first_front_only=False):
    """Fast non-dominated sort (Deb et al. 2002)."""
    if k is None:
        k = len(individuals)
    fronts: List[List] = [[]]
    domination_count = {}
    dominated_set = {}
    for i, p in enumerate(individuals):
        domination_count[i] = 0
        dominated_set[i] = []
    for i, p in enumerate(individuals):
        for j, q in enumerate(individuals):
            if i == j:
                continue
            if dominates(p.fitness_values, q.fitness_values):
                dominated_set[i].append(j)
            elif dominates(q.fitness_values, p.fitness_values):
                domination_count[i] += 1
        if domination_count[i] == 0:
            fronts[0].append(i)
    if first_front_only:
        return [[individuals[i] for i in fronts[0]]]
    filled = len(fronts[0])
    while filled < k and fronts[-1]:
        next_front = []
        for i in fronts[-1]:
            for j in dominated_set[i]:
                domination_count[j] -= 1
                if domination_count[j] == 0:
                    next_front.append(j)
        if not next_front:
            break
        fronts.append(next_front)
        filled += len(next_front)
    return [[individuals[i] for i in front] for front in fronts]


def assign_crowding_distance(front):
    """Attach `crowding_distance` to every individual of a front."""
    n = len(front)
    if n == 0:
        return
    for ind in front:
        ind.crowding_distance = 0.0
    if n <= 2:
        for ind in front:
            ind.crowding_distance = math.inf
        return
    n_obj = len(front[0].fitness_values)
    for m in range(n_obj):
        front.sort(key=lambda ind: ind.fitness_values[m])
        front[0].crowding_distance = math.inf
        front[-1].crowding_distance = math.inf
        span = front[-1].fitness_values[m] - front[0].fitness_values[m]
        if span <= 0 or math.isinf(span) or math.isnan(span):
            continue
        for i in range(1, n - 1):
            front[i].crowding_distance += (
                front[i + 1].fitness_values[m] - front[i - 1].fitness_values[m]
            ) / span


def sel_nsga2(individuals, k, rng: random.Random = random):
    fronts = sort_nondominated(individuals, k)
    chosen: List = []
    for front in fronts:
        assign_crowding_distance(front)
        if len(chosen) + len(front) <= k:
            chosen.extend(front)
        else:
            front.sort(key=lambda ind: ind.crowding_distance, reverse=True)
            chosen.extend(front[: k - len(chosen)])
            break
    return chosen


def sel_tournament_dcd(individuals, k, rng: random.Random = random):
    """Dominance + crowding-distance binary tournament (requires NSGA-II
    attributes from a prior sel_nsga2 call; computes them if missing)."""
    if any(not hasattr(ind, "crowding_distance") for ind in individuals):
        for front in sort_nondominated(individuals):
            assign_crowding_distance(front)

    def tourn(a, b):
        if dominates(a.fitness_values, b.fitness_values):
            return a
        if dominates(b.fitness_values, a.fitness_values):
            return b
        if a.crowding_distance > b.crowding_distance:
            return a
        if b.crowding_distance > a.crowding_distance:
            return b
        return a if rng.random() < 0.5 else b

    chosen = []
    pool = list(individuals)
    if len(pool) == 1:
        # Degenerate population: the pairwise loop below would never
        # append (infinite loop) — replicate the lone individual.
        return [pool[0]] * k
    while len(chosen) < k:
        rng.shuffle(pool)
        for i in range(0, len(pool) - 1, 2):
            chosen.append(tourn(pool[i], pool[i + 1]))
            if len(chosen) == k:
                break
    return chosen


def sel_tournament(individuals, k, tournsize=2, rng: random.Random = random):
    chosen = []
    for _ in range(k):
        aspirants = [rng.choice(individuals) for _ in range(tournsize)]
        chosen.append(min(aspirants, key=lambda ind: ind.fitness_values))
    return chosen


def sel_random(individuals, k, rng: random.Random = random):
    return [rng.choice(individuals) for _ in range(k)]


def sel_best(individuals, k):
    return sorted(individuals, key=lambda ind: ind.fitness_values)[:k]


# --- NSGA-III ----------------------------------------------------------------


def uniform_reference_points(n_obj: int, p: int) -> np.ndarray:
    """Das–Dennis uniformly distributed reference points on the simplex."""

    def gen(points, left, total, depth):
        if depth == n_obj - 1:
            points.append(left / total)
            return [np.array(points)]
        out = []
        for i in range(left + 1):
            out.extend(gen(points + [i / total], left - i, total, depth + 1))
        return out

    return np.array(gen([], p, p, 0))


def normalize_deb_jain(fits: np.ndarray) -> np.ndarray:
    """Deb & Jain (2014) adaptive normalization for NSGA-III.

    Exact construction (reference delegates to deap.tools.selNSGA3, used at
    reference optimization/program.py:720-768): translate by the ideal
    point, locate one extreme point per objective via the achievement
    scalarizing function (axis weights with 1e-6 elsewhere), then solve for
    the hyperplane through the extreme points and normalize by its axis
    intercepts.  Falls back to the per-objective pool maximum (nadir
    estimate) when the extreme-point system is degenerate — singular
    matrix, non-finite or non-positive intercepts — as prescribed by the
    paper and standard implementations.
    """
    fits = np.asarray(fits, dtype=float)
    ideal = fits.min(axis=0)
    translated = fits - ideal
    n_obj = fits.shape[1]

    weights = np.full((n_obj, n_obj), 1e-6)
    np.fill_diagonal(weights, 1.0)
    # asf[j, i] = max_m translated[i, m] / weights[j, m]
    asf = (translated[None, :, :] / weights[:, None, :]).max(axis=2)
    extreme_idx = asf.argmin(axis=1)
    extremes = translated[extreme_idx]

    nadir = translated.max(axis=0)
    nadir = np.where(nadir > 0, nadir, 1.0)
    intercepts = None
    try:
        plane = np.linalg.solve(extremes, np.ones(n_obj))
        with np.errstate(divide="ignore", over="ignore"):
            candidate = 1.0 / plane
        if np.all(np.isfinite(candidate)) and np.all(candidate > 1e-12):
            intercepts = candidate
    except np.linalg.LinAlgError:
        pass
    if intercepts is None:
        intercepts = nadir
    return translated / intercepts


def sel_nsga3(individuals, k, ref_points: np.ndarray, rng: random.Random = random):
    """NSGA-III niching selection (Deb & Jain 2014), minimization."""
    fronts = sort_nondominated(individuals, k)
    chosen: List = []
    for front in fronts:
        if len(chosen) + len(front) <= k:
            chosen.extend(front)
        else:
            last_front = front
            break
    else:
        return chosen
    if len(chosen) == k:
        return chosen

    pool = chosen + last_front
    fits = np.array([ind.fitness_values for ind in pool], dtype=float)
    fits = np.where(np.isfinite(fits), fits, 1e18)
    normalized = normalize_deb_jain(fits)

    norms = np.linalg.norm(ref_points, axis=1, keepdims=True)
    directions = ref_points / np.where(norms > 0, norms, 1.0)
    # perpendicular distance of each individual to each reference line
    proj = normalized @ directions.T
    dists = np.linalg.norm(
        normalized[:, None, :] - proj[:, :, None] * directions[None, :, :], axis=2
    )
    assoc = dists.argmin(axis=1)
    assoc_dist = dists[np.arange(len(pool)), assoc]

    niche_counts = np.zeros(len(ref_points), dtype=int)
    for idx in assoc[: len(chosen)]:
        niche_counts[idx] += 1

    candidates = list(range(len(chosen), len(pool)))
    while len(chosen) < k and candidates:
        available_niches = set(assoc[i] for i in candidates)
        niche = min(available_niches, key=lambda n: (niche_counts[n], rng.random()))
        members = [i for i in candidates if assoc[i] == niche]
        if niche_counts[niche] == 0:
            pick = min(members, key=lambda i: assoc_dist[i])
        else:
            pick = rng.choice(members)
        chosen.append(pool[pick])
        candidates.remove(pick)
        niche_counts[niche] += 1
    return chosen
