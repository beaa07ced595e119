"""2D Helmholtz with complex shifted-Laplacian preconditioning (counterpart
of evostencils_tpu/problems/helmholtz.py).

  * A = -Δ - k²          (the indefinite Helmholtz operator),
  * M = -Δ - (1+0.5j)k²  (the complex-shifted preconditioner whose
    multigrid cycle is what evolution designs; Equation PrecEq: M·u == f),
  * RHS: B-spline approximation of a centered Dirac pulse,
  * outer solve: right-preconditioned BiCGStab on A·x = b, one evolved
    cycle per preconditioner application, target 1e-7, cap 10000
    (ops/krylov.preconditioned_bicgstab),
  * generalization ladder: k = 80·2^i with h·k ≈ 0.625 fixed, i.e.
    max_level grows with k.

Boundaries are homogeneous Dirichlet by default.  `boundary="robin"` folds
first-order radiation conditions into a position-dependent complex centre
plane (stencils/gallery.Helmholtz2DRobin), for M and for the outer A alike:
both become variable-coefficient operators.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from evostencils_torch.ir import base
from evostencils_torch.problems.api import Problem
from evostencils_torch.stencils import gallery


def dirac_pulse_rhs(x, y):
    """B-spline hat approximation of δ(x-0.5, y-0.5)."""
    n = x.shape[0] + 1
    h = 1.0 / n
    gx = np.maximum(0.0, -(np.abs(x - 0.5) - h) / h**2)
    gy = np.maximum(0.0, -(np.abs(y - 0.5) - h) / h**2)
    return gx * gy


def max_level_for_k(k: float, hk: float = 0.625) -> int:
    """Level with h·k ≈ hk: h = 2^-level → level = log2(k / hk)."""
    return int(round(math.log2(k / hk)))


def helmholtz_2d(min_level=3, max_level=7, k=80.0, shift=complex(1.0, 0.5),
                 boundary="dirichlet", dtype=None) -> Problem:
    if boundary not in ("dirichlet", "robin"):
        raise ValueError(f"Unknown boundary {boundary!r}")
    generator = gallery.Helmholtz2DRobin if boundary == "robin" else gallery.Helmholtz2D

    def preconditioner_factory(level, params):
        return generator(params.get("k", k), params.get("shift", shift))

    def outer_factory(level, params):
        return generator(params.get("k", k), 1.0)

    return Problem(
        name="2D_FD_Helmholtz",
        dimension=2,
        min_level=min_level,
        max_level=max_level,
        fields=["u"],
        equation_strings=[("PrecEq", "M * u == f")],
        operator_factories={
            "M": (preconditioner_factory, base.Operator),
            "R_u": (
                lambda level, params: gallery.FullWeightingRestrictionGenerator((2, 2)),
                base.Restriction,
            ),
            "P_u": (
                lambda level, params: gallery.MultilinearInterpolationGenerator((2, 2)),
                base.Prolongation,
            ),
        },
        rhs_functions=[dirac_pulse_rhs],
        dtype=dtype if dtype is not None else torch.complex64,
        parameters={"k": k, "shift": shift},
        outer_solver={
            "type": "preconditioned_bicgstab",
            "operator_factory": outer_factory,
            "target_reduction": 1e-7,
            "max_iterations": 10000,
        },
        residual_target=1e-7,
        iteration_limit=10000,
    )


def helmholtz_ladder(n_steps: int = 3, k0: float = 80.0):
    """(k, max_level) ladder with h·k = 0.625."""
    return [(k0 * 2**i, max_level_for_k(k0 * 2**i)) for i in range(n_steps)]
