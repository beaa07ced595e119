"""CMA-ES optimization of restriction/prolongation stencil weights (a copy
of evostencils_tpu/optimization/intergrid_transfer.py that imports the
port's IR, stencils and LFA model).

The weight vector parameterizes the R/P stencils of a two-grid correction
whose spectral radius the LFA model (models/lfa.py, numpy) predicts:
thousands of evaluations per second, no cycle run in the loop.  A caller
may pass its own `evaluate` instead.  `CMAES` is also what
`optimization.relaxation.tune_outer_relaxation` uses.

The CMA-ES itself is self-contained ((μ/μ_w, λ) with rank-μ/rank-one
covariance adaptation and step-size control, Hansen's standard strategy).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from evostencils_torch.ir import base, smoother, system
from evostencils_torch.ir import partitioning as part
from evostencils_torch.stencils import constant


class CMAES:
    """Minimal (μ/μ_w, λ)-CMA-ES (Hansen 2016 tutorial equations)."""

    def __init__(self, x0: np.ndarray, sigma: float, population_size: Optional[int] = None,
                 seed: int = 0):
        self.n = len(x0)
        self.mean = np.asarray(x0, dtype=float).copy()
        self.sigma = sigma
        self.lam = population_size or 4 + int(3 * math.log(self.n))
        self.mu = self.lam // 2
        weights = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = weights / weights.sum()
        self.mu_eff = 1.0 / np.sum(self.weights**2)
        n = self.n
        self.cc = (4 + self.mu_eff / n) / (n + 4 + 2 * self.mu_eff / n)
        self.cs = (self.mu_eff + 2) / (n + self.mu_eff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mu_eff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mu_eff - 2 + 1 / self.mu_eff) / ((n + 2) ** 2 + self.mu_eff),
        )
        self.damps = 1 + 2 * max(0, math.sqrt((self.mu_eff - 1) / (n + 1)) - 1) + self.cs
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
        self.rng = np.random.default_rng(seed)

    def ask(self) -> np.ndarray:
        eigvals, eigvecs = np.linalg.eigh(self.C)
        eigvals = np.maximum(eigvals, 1e-20)
        bd = eigvecs * np.sqrt(eigvals)
        z = self.rng.standard_normal((self.lam, self.n))
        self._last_z = z
        self._bd = bd
        return self.mean + self.sigma * z @ bd.T

    def tell(self, solutions: np.ndarray, fitnesses: np.ndarray):
        order = np.argsort(fitnesses)
        selected = solutions[order[: self.mu]]
        old_mean = self.mean
        self.mean = self.weights @ selected
        y = (self.mean - old_mean) / self.sigma
        c_inv_sqrt = self._inv_sqrt()
        self.ps = (1 - self.cs) * self.ps + math.sqrt(
            self.cs * (2 - self.cs) * self.mu_eff
        ) * (c_inv_sqrt @ y)
        hsig = float(
            np.linalg.norm(self.ps)
            / math.sqrt(1 - (1 - self.cs) ** (2 * (1 + 1)))
            < (1.4 + 2 / (self.n + 1)) * self.chi_n
        )
        self.pc = (1 - self.cc) * self.pc + hsig * math.sqrt(
            self.cc * (2 - self.cc) * self.mu_eff
        ) * y
        artmp = (selected - old_mean) / self.sigma
        self.C = (
            (1 - self.c1 - self.cmu) * self.C
            + self.c1
            * (
                np.outer(self.pc, self.pc)
                + (1 - hsig) * self.cc * (2 - self.cc) * self.C
            )
            + self.cmu * (artmp.T * self.weights) @ artmp
        )
        self.sigma *= math.exp(
            (self.cs / self.damps) * (np.linalg.norm(self.ps) / self.chi_n - 1)
        )

    def _inv_sqrt(self):
        eigvals, eigvecs = np.linalg.eigh(self.C)
        eigvals = np.maximum(eigvals, 1e-20)
        return eigvecs @ np.diag(eigvals**-0.5) @ eigvecs.T


def symmetric_window_offsets(radius: int, dimension: int) -> List[Tuple[int, ...]]:
    return list(itertools.product(range(-radius, radius + 1), repeat=dimension))


def weights_to_stencils(weights: np.ndarray, offsets, dimension):
    """Split the weight vector into (restriction, prolongation) stencils."""
    n = len(offsets)
    restriction = constant.Stencil(list(zip(offsets, weights[:n])), dimension)
    prolongation = constant.Stencil(list(zip(offsets, weights[n:])), dimension)
    return restriction, prolongation


def two_grid_context(problem):
    """Candidate-invariant pieces of the two-grid expression (sympy
    equation expansion dominates; build once per optimization, not per
    CMA-ES candidate)."""
    from evostencils_torch.grammar import multigrid as mg

    approximation = problem.approximation()
    rhs = problem.rhs()
    fine_grid = approximation.grid
    coarse_grid = system.get_coarse_grid(fine_grid, problem.coarsening_factors)
    operator, _, _ = mg.generate_operators_on_level(
        problem.equations, problem.operators, problem.fields,
        problem.max_level, 0, fine_grid, coarse_grid,
    )
    coarse_operator = mg.generate_system_operator(
        problem.equations, problem.operators, problem.fields,
        problem.max_level - 1, 1, coarse_grid,
    )
    return approximation, rhs, fine_grid, coarse_grid, operator, coarse_operator


def build_two_grid_expression(problem, restriction_stencil, prolongation_stencil,
                              pre_smoothing=1, post_smoothing=1, omega=0.8,
                              context=None):
    """Two-grid correction with parameterized transfers (the expression the
    reference builds at intergrid_transfer.py:67-86)."""
    if context is None:
        context = two_grid_context(problem)
    (approximation, rhs, fine_grid, coarse_grid, operator,
     coarse_operator) = context
    restriction = system.Restriction(
        "R_opt",
        [
            base.Restriction(
                "R_opt", fine_grid[i], coarse_grid[i],
                base.ConstantStencilGenerator(restriction_stencil),
            )
            for i in range(len(fine_grid))
        ],
    )
    prolongation = system.Prolongation(
        "P_opt",
        [
            base.Prolongation(
                "P_opt", fine_grid[i], coarse_grid[i],
                base.ConstantStencilGenerator(prolongation_stencil),
            )
            for i in range(len(fine_grid))
        ],
    )

    u = approximation
    for _ in range(pre_smoothing):
        res = base.Residual(operator, u, rhs)
        corr = base.Multiplication(
            base.Inverse(smoother.generate_collective_jacobi(operator)), res
        )
        u = base.Cycle(u, rhs, corr, partitioning=part.RedBlack, relaxation_factor=omega)
    res = base.Residual(operator, u, rhs)
    f_c = base.Multiplication(restriction, res)
    cgc = base.Multiplication(base.CoarseGridSolver("CGS", coarse_operator), f_c)
    corr = base.Multiplication(prolongation, cgc)
    u = base.Cycle(u, rhs, corr, relaxation_factor=1.0)
    for _ in range(post_smoothing):
        res = base.Residual(operator, u, rhs)
        corr = base.Multiplication(
            base.Inverse(smoother.generate_collective_jacobi(operator)), res
        )
        u = base.Cycle(u, rhs, corr, partitioning=part.RedBlack, relaxation_factor=omega)
    return u


def optimize_intergrid_weights(
    problem,
    radius: int = 1,
    generations: int = 30,
    sigma: float = 0.2,
    population_size: Optional[int] = None,
    samples_per_axis: int = 8,
    seed: int = 0,
    evaluate: Optional[Callable] = None,
    verbose: bool = False,
):
    """CMA-ES over the (2r+1)^d R and P weights; fitness = LFA ρ of the
    two-grid correction.  Returns (restriction, prolongation, ρ, history)."""
    from evostencils_torch.ir.transformations import invalidate_expression
    from evostencils_torch.models.lfa import ConvergenceEvaluator

    dimension = problem.dimension
    offsets = symmetric_window_offsets(radius, dimension)
    from evostencils_torch.stencils import gallery

    fw = dict(gallery.full_weighting_restriction_stencil(dimension).entries)
    ml = dict(gallery.multilinear_interpolation_stencil(dimension).entries)
    x0 = np.array(
        [fw.get(o, 0.0) for o in offsets] + [ml.get(o, 0.0) for o in offsets],
        dtype=float,
    )
    lfa = ConvergenceEvaluator(
        dimension, problem.coarsening_factors, problem.finest_grid,
        samples_per_axis=samples_per_axis,
    )

    context = two_grid_context(problem)

    def default_evaluate(weights) -> float:
        r_st, p_st = weights_to_stencils(weights, offsets, dimension)
        expression = build_two_grid_expression(problem, r_st, p_st,
                                               context=context)
        rho = lfa.compute_spectral_radius(expression)
        invalidate_expression(expression)
        if rho == 0.0 or not math.isfinite(rho):
            return 1e6
        return rho

    evaluate = evaluate or default_evaluate
    es = CMAES(x0, sigma, population_size, seed)
    best = (evaluate(x0), x0)  # the FW/bilinear incumbent is the baseline
    history = [best[0]]
    for gen in range(generations):
        solutions = es.ask()
        fitnesses = np.array([evaluate(x) for x in solutions])
        es.tell(solutions, fitnesses)
        i = int(np.argmin(fitnesses))
        if fitnesses[i] < best[0]:
            best = (float(fitnesses[i]), solutions[i].copy())
        history.append(float(fitnesses[i]))
        if verbose:
            print(f"cma gen {gen}: best rho {best[0]:.4f}", flush=True)
    r_st, p_st = weights_to_stencils(best[1], offsets, dimension)
    return r_st, p_st, best[0], history
