"""Nonlinear FAS model problem -Δu + γ·u·eᵘ = f (counterpart of
evostencils_tpu/problems/fas.py).

  * operator A(u) = L·u + γ·u·eᵘ with L the 5-point -Δ and γ = 20,
  * manufactured solution (x² − x³)·sin(3πy) with the matching RHS,
  * Newton–Jacobi smoothing with the denominator diag(L) + γ(1+u)eᵘ,
  * coarsest-grid solve: 200 damped Picard sweeps (backend/lowering.py),
  * solve protocol: residual reduction 1e-10, iteration cap 300.

The grammar runs in FAS mode (τ-corrected restriction, Picard and Newton
smoother productions, solution-restriction coarse-grid correction).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from evostencils_torch.ir import base
from evostencils_torch.problems.api import Problem
from evostencils_torch.stencils import constant, gallery


class NonlinearLambdaExpGenerator:
    """Stencil generator of A(u) = L·u + γ·u·eᵘ (a pointwise nonlinearity).

    The nonlinear protocol the lowering uses (backend/lowering.py):
    `apply`, `nonlinear_term`, `derivative_diag`, `linear_center`; and
    `generate_stencil`, the linearisation at u = 0 (L + γ·I), for the
    stencil algebra (diagonal splits, block smoothers)."""

    is_nonlinear = True

    def __init__(self, gamma: float = 20.0):
        self.gamma = gamma
        self._laplace_cache = {}

    def is_variable(self):
        return False

    def _laplace(self, grid) -> constant.Stencil:
        if grid not in self._laplace_cache:
            self._laplace_cache[grid] = gallery.Poisson2D().generate_stencil(grid)
        return self._laplace_cache[grid]

    def generate_stencil(self, grid):
        return constant.add(self._laplace(grid), constant.Stencil([((0, 0), self.gamma)]))

    # ---- nonlinear protocol ----

    def apply(self, u, grid):
        from evostencils_torch.ops.stencil_ops import apply_constant_stencil

        return apply_constant_stencil(u, self._laplace(grid)) + self.nonlinear_term(u)

    def nonlinear_term(self, u):
        return self.gamma * u * torch.exp(u)

    def derivative_diag(self, u):
        return self.gamma * (1.0 + u) * torch.exp(u)

    def linear_center(self, grid):
        return self._laplace(grid).center_value()


def _solution(x, y):
    return (x**2 - x**3) * np.sin(3 * math.pi * y)


def _rhs(x, y, gamma=20.0):
    """RHS of the FAS template's manufactured solution."""
    return (
        (9.0 * math.pi**2 + gamma * np.exp(_solution(x, y))) * (x**2 - x**3)
        + 6.0 * x
        - 2.0
    ) * np.sin(3 * math.pi * y)


def fas_2d(min_level=6, max_level=10, gamma=20.0, dtype=torch.float32) -> Problem:
    return Problem(
        name="FAS_2D_Basic",
        dimension=2,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("eq_u", "A * u == f")],
        operator_factories={
            "A": (
                lambda level, params: NonlinearLambdaExpGenerator(params.get("gamma", gamma)),
                base.Operator,
            ),
            "R": (
                lambda level, params: gallery.FullWeightingRestrictionGenerator((2, 2)),
                base.Restriction,
            ),
            "P": (
                lambda level, params: gallery.MultilinearInterpolationGenerator((2, 2)),
                base.Prolongation,
            ),
        },
        rhs_functions=[lambda x, y: _rhs(x, y, gamma)],
        dtype=dtype,
        parameters={"gamma": gamma},
        uses_fas=True,
        residual_target=1e-10,
        iteration_limit=300,
    )
