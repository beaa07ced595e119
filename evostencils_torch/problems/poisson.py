"""Poisson model problems (counterpart of evostencils_tpu/problems/poisson.py).

  * 1D, 2D (minLevel 5 / maxLevel 9 by default) and 3D 7-point
    finite-difference Poisson,
  * variable-coefficient -div(a ∇u) in 2D and 3D with
    a = exp(κ x(1-x)y(1-y)[z(1-z)]), κ = 10 by default.

Boundaries are homogeneous Dirichlet; the manufactured RHS
f = d·π²·∏ sin(πx_i) gives the separable product-of-sines solution.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from evostencils_torch.ir import base
from evostencils_torch.problems.api import Problem
from evostencils_torch.stencils import gallery


def _rhs_sines(*coords):
    d = len(coords)
    out = d * math.pi**2
    for c in coords:
        out = out * np.sin(math.pi * c)
    return out


def _standard_operators(dimension, operator_generator):
    return {
        "A": (lambda level, params: operator_generator(params), base.Operator),
        "R": (
            lambda level, params: gallery.FullWeightingRestrictionGenerator((2,) * dimension),
            base.Restriction,
        ),
        "P": (
            lambda level, params: gallery.MultilinearInterpolationGenerator((2,) * dimension),
            base.Prolongation,
        ),
    }


def poisson_1d(min_level=4, max_level=10, dtype=torch.float32) -> Problem:
    return Problem(
        name="1D_FD_Poisson",
        dimension=1,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("eq_u", "A * u == f")],
        operator_factories=_standard_operators(1, lambda params: gallery.Poisson1D()),
        rhs_functions=[_rhs_sines],
        dtype=dtype,
    )


def poisson_2d(min_level=5, max_level=9, dtype=torch.float32, epsilon_anisotropy=1.0) -> Problem:
    return Problem(
        name="2D_FD_Poisson",
        dimension=2,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("eq_u", "A * u == f")],
        operator_factories=_standard_operators(
            2, lambda params: gallery.Poisson2D(params.get("epsilon", epsilon_anisotropy))
        ),
        rhs_functions=[_rhs_sines],
        dtype=dtype,
        parameters={"epsilon": epsilon_anisotropy},
    )


def poisson_3d(min_level=3, max_level=7, dtype=torch.float32) -> Problem:
    return Problem(
        name="3D_FD_Poisson",
        dimension=3,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("eq_u", "A * u == f")],
        operator_factories=_standard_operators(3, lambda params: gallery.Poisson3D()),
        rhs_functions=[_rhs_sines],
        dtype=dtype,
    )


def poisson_2d_variable(min_level=5, max_level=9, kappa=10.0, dtype=torch.float32) -> Problem:
    def factory(params):
        k = params.get("kappa", kappa)
        return gallery.Poisson2DVariableCoefficients(
            lambda x, y: np.exp(k * ((x - x * x) * (y - y * y)))
        )

    return Problem(
        name="2D_FD_Poisson_VarCoeff",
        dimension=2,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("eq_u", "A * u == f")],
        operator_factories=_standard_operators(2, factory),
        rhs_functions=[_rhs_sines],
        dtype=dtype,
        parameters={"kappa": kappa},
    )


def poisson_3d_variable(min_level=3, max_level=6, kappa=10.0, dtype=torch.float32) -> Problem:
    def factory(params):
        k = params.get("kappa", kappa)
        return gallery.Poisson3DVariableCoefficients(
            lambda x, y, z: np.exp(k * ((x - x * x) * (y - y * y) * (z - z * z)))
        )

    return Problem(
        name="3D_FD_Poisson_VarCoeff",
        dimension=3,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("eq_u", "A * u == f")],
        operator_factories=_standard_operators(3, factory),
        rhs_functions=[_rhs_sines],
        dtype=dtype,
        parameters={"kappa": kappa},
    )
