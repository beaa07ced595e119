"""2D linear elasticity: the coupled two-field (u, v) system (counterpart of
evostencils_tpu/problems/elasticity.py).

    (λ+μ)(dxx·u + dxy·v) + λ·Δu == RHS_u
    (λ+μ)(dxy·u + dyy·v) + λ·Δv == RHS_v

with λ = 195, μ = 130 and Dirichlet boundaries; the inhomogeneous boundary
profile of v is folded into the right-hand side.  The problem exercises the
block-system paths: decoupled and collective point smoothers, collective
block-Jacobi local solves over both fields, and a two-field dense coarse
solve.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from evostencils_torch.ir import base
from evostencils_torch.problems.api import Problem
from evostencils_torch.stencils import constant, gallery


class _Dxx(gallery.StencilGenerator):
    def generate_stencil(self, grid):
        h0, _ = grid.spacing
        return constant.Stencil(
            [((0, 0), -2.0 / h0**2), ((-1, 0), 1.0 / h0**2), ((1, 0), 1.0 / h0**2)]
        )


class _Dyy(gallery.StencilGenerator):
    def generate_stencil(self, grid):
        _, h1 = grid.spacing
        return constant.Stencil(
            [((0, 0), -2.0 / h1**2), ((0, -1), 1.0 / h1**2), ((0, 1), 1.0 / h1**2)]
        )


class _Dxy(gallery.StencilGenerator):
    def generate_stencil(self, grid):
        h0, h1 = grid.spacing
        c = 1.0 / (4.0 * h0 * h1)
        return constant.Stencil(
            [((-1, 1), -c), ((1, 1), c), ((-1, -1), c), ((1, -1), -c)]
        )


class _SignedLaplace(gallery.StencilGenerator):
    """+Δ (negative definite), the reference's sign convention."""

    def generate_stencil(self, grid):
        h0, h1 = grid.spacing
        return constant.Stencil(
            [
                ((0, 0), -2.0 / h0**2 - 2.0 / h1**2),
                ((-1, 0), 1.0 / h0**2),
                ((1, 0), 1.0 / h0**2),
                ((0, -1), 1.0 / h1**2),
                ((0, 1), 1.0 / h1**2),
            ]
        )


def _boundary_rhs_v(x, y):
    """The Dirichlet data of v, v = 0.4·sin(πx)(1−x)x·y on the boundary
    (non-zero on the y = 1 edge only), folded into the right-hand side of
    the last interior row."""
    n = x.shape[1] + 1
    h = 1.0 / n
    g_top = 0.4 * np.sin(math.pi * x[:, -1]) * (1.0 - x[:, -1]) * x[:, -1] * 1.0
    out = np.zeros_like(x)
    out[:, -1] = -(1.0 / h**2) * g_top
    return out


def linear_elasticity_2d(min_level=4, max_level=8, lam=195.0, mu=130.0,
                         dtype=torch.float32) -> Problem:
    return Problem(
        name="2D_FD_LinearElasticity",
        dimension=2,
        min_level=min_level,
        max_level=max_level,
        fields=["u", "v"],
        equation_strings=[
            ("uEq", "(lam + mu) * (dxx * u + dxy * v) + lam * Laplace * u == RHS_u"),
            ("vEq", "(lam + mu) * (dxy * u + dyy * v) + lam * Laplace * v == RHS_v"),
        ],
        operator_factories={
            "dxx": (lambda level, params: _Dxx(), base.Operator),
            "dyy": (lambda level, params: _Dyy(), base.Operator),
            "dxy": (lambda level, params: _Dxy(), base.Operator),
            "Laplace": (lambda level, params: _SignedLaplace(), base.Operator),
            "R_u": (
                lambda level, params: gallery.FullWeightingRestrictionGenerator((2, 2)),
                base.Restriction,
            ),
            "R_v": (
                lambda level, params: gallery.FullWeightingRestrictionGenerator((2, 2)),
                base.Restriction,
            ),
            "P_u": (
                lambda level, params: gallery.MultilinearInterpolationGenerator((2, 2)),
                base.Prolongation,
            ),
            "P_v": (
                lambda level, params: gallery.MultilinearInterpolationGenerator((2, 2)),
                base.Prolongation,
            ),
        },
        rhs_functions=[lambda x, y: np.zeros_like(x), _boundary_rhs_v],
        dtype=dtype,
        constants={"lam": lam, "mu": mu},
    )
