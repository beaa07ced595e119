"""2D Poisson model problem (counterpart of evostencils_tpu/problems/poisson.py).

The reference's finite-difference Poisson configuration, minLevel 5 /
maxLevel 9 by default, homogeneous Dirichlet boundary and the manufactured
RHS f = d·π²·∏ sin(πx_i).  The other families (1D, 3D, variable
coefficients) are not ported yet.
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
