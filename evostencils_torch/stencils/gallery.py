"""Built-in stencil generators (discretized operators).

Parity with upstream evostencils/stencils/gallery.py:5-250, minus the
LFA-Lab dependency: multilinear interpolation and full-weighting restriction
stencils are generated analytically (tensor-product hat-function weights)
instead of being queried from lfa_lab (reference gallery.py:188-219).

Each generator produces a position-independent `constant.Stencil` via
`generate_stencil(grid)`.  Variable-coefficient generators additionally
expose `generate_coefficient_arrays(grid)` which returns one numpy
coefficient plane per stencil offset, evaluated at every interior grid
node — this is what the JAX backend consumes to apply the operator as a
sum of coefficient-weighted shifted loads.
"""

from __future__ import annotations

import abc
import itertools
from typing import Callable, Sequence, Tuple

import numpy as np

from evostencils_torch.stencils import constant


class StencilGenerator(abc.ABC):
    @abc.abstractmethod
    def generate_stencil(self, grid) -> constant.Stencil:
        ...

    def is_variable(self) -> bool:
        return False


class Poisson1D(StencilGenerator):
    """-u'' ≈ [-1 2 -1]/h² (reference gallery.py:16-29)."""

    def generate_stencil(self, grid):
        (h,) = grid.spacing
        return constant.Stencil(
            [((-1,), -1 / (h * h)), ((0,), 2 / (h * h)), ((1,), -1 / (h * h))]
        )


class Poisson2D(StencilGenerator):
    """5-point -Δ with optional anisotropy eps (reference gallery.py:32-55)."""

    def __init__(self, epsilon: float = 1.0):
        self.epsilon = epsilon

    def generate_stencil(self, grid):
        h0, h1 = grid.spacing
        eps = self.epsilon
        return constant.Stencil(
            [
                ((0, -1), -1 / (h1 * h1)),
                ((-1, 0), -eps / (h0 * h0)),
                ((0, 0), 2 * eps / (h0 * h0) + 2 / (h1 * h1)),
                ((1, 0), -eps / (h0 * h0)),
                ((0, 1), -1 / (h1 * h1)),
            ]
        )


class Poisson3D(StencilGenerator):
    """7-point -Δ (reference gallery.py:58-90)."""

    def generate_stencil(self, grid):
        h0, h1, h2 = grid.spacing
        return constant.Stencil(
            [
                ((0, 0, 0), 2 / (h0 * h0) + 2 / (h1 * h1) + 2 / (h2 * h2)),
                ((-1, 0, 0), -1 / (h0 * h0)),
                ((1, 0, 0), -1 / (h0 * h0)),
                ((0, -1, 0), -1 / (h1 * h1)),
                ((0, 1, 0), -1 / (h1 * h1)),
                ((0, 0, -1), -1 / (h2 * h2)),
                ((0, 0, 1), -1 / (h2 * h2)),
            ]
        )


class Helmholtz2D(StencilGenerator):
    """5-point -Δ - (k² · shift) with complex shift (shifted Laplacian).

    shift=1 gives the Helmholtz operator A; shift=(1+0.5j) gives the
    complex-shifted preconditioner M of the reference Helmholtz setup
    (example_problems/Helmholtz/2D_FD_Helmholtz_fromL3.exa3 Globals).
    """

    def __init__(self, k: float, shift: complex = 1.0):
        self.k = k
        self.shift = shift

    def generate_stencil(self, grid):
        h0, h1 = grid.spacing
        center = 2 / (h0 * h0) + 2 / (h1 * h1) - self.shift * self.k**2
        return constant.Stencil(
            [
                ((0, -1), -1 / (h1 * h1)),
                ((-1, 0), -1 / (h0 * h0)),
                ((0, 0), center),
                ((1, 0), -1 / (h0 * h0)),
                ((0, 1), -1 / (h1 * h1)),
            ]
        )


class Helmholtz2DRobin(StencilGenerator):
    """Shifted Helmholtz with first-order Robin (radiation) boundaries.

    The reference's Helmholtz config applies Robin conditions
    du/dn − i·k·u = 0 on the boundary (2D_FD_Helmholtz_fromL3 applyBC_*).
    On the interior-only representation, eliminating the boundary value
    u_b = u_i / (1 − i·k·h) folds the condition into the boundary-adjacent
    stencil rows — a position-dependent (complex) coefficient field, so
    this generator is variable-coefficient: the center plane gains
    −(1/h²)/(1 − i·k·h) at nodes adjacent to each boundary face.
    """

    def __init__(self, k: float, shift: complex = 1.0):
        self.k = k
        self.shift = shift

    def is_variable(self) -> bool:
        return True

    def generate_stencil(self, grid):
        # Interior sample (used by symbolic/LFA paths, which are
        # boundary-agnostic): identical to the Dirichlet operator.
        return Helmholtz2D(self.k, self.shift).generate_stencil(grid)

    def generate_coefficient_arrays(self, grid):
        import numpy as np

        h0, h1 = grid.spacing
        n0, n1 = grid.interior_shape
        center_val = 2 / (h0 * h0) + 2 / (h1 * h1) - self.shift * self.k**2
        center = np.full((n0, n1), center_val, dtype=np.complex128)
        # Robin elimination factor per face (first-order ghost elimination).
        for axis, h in ((0, h0), (1, h1)):
            factor = (1.0 / (h * h)) / (1.0 - 1j * self.k * h)
            if axis == 0:
                center[0, :] -= factor
                center[-1, :] -= factor
            else:
                center[:, 0] -= factor
                center[:, -1] -= factor
        offsets = [(0, -1), (-1, 0), (0, 0), (1, 0), (0, 1)]
        planes = [
            np.full((n0, n1), -1 / (h1 * h1), dtype=np.complex128),
            np.full((n0, n1), -1 / (h0 * h0), dtype=np.complex128),
            center,
            np.full((n0, n1), -1 / (h0 * h0), dtype=np.complex128),
            np.full((n0, n1), -1 / (h1 * h1), dtype=np.complex128),
        ]
        return tuple(offsets), planes


def default_coefficient_2d(x, y, kappa=10.0):
    """exp(kappa·x(1-x)·y(1-y)) — reference gallery.py:87-90 (numpy-vectorized)."""
    return np.exp(kappa * ((x - x * x) * (y - y * y)))


def default_coefficient_3d(x, y, z, kappa=10.0):
    return np.exp(kappa * ((x - x * x) * (y - y * y) * (z - z * z)))


class _VariableCoefficientPoisson(StencilGenerator):
    """-div(a(x) grad u) with a flux (finite-volume) discretization.

    Per-axis fluxes are evaluated at half-node positions; parity with
    reference gallery.py:93-186.  `position` selects the sample point for
    the constant-stencil view (used by symbolic analysis);
    `generate_coefficient_arrays` evaluates all interior nodes at once.
    """

    def __init__(self, coefficient_function: Callable, position: Sequence[float]):
        self.get_coefficient = coefficient_function
        self.position = tuple(position)
        if len(self.position) < 1:
            raise ValueError("Position must be non-empty")

    def is_variable(self) -> bool:
        return True

    def _entries_at(self, pos, spacing):
        dim = len(pos)
        entries = []
        center = 0.0
        for axis in range(dim):
            h = spacing[axis]
            plus = list(pos)
            minus = list(pos)
            plus[axis] = pos[axis] + 0.5 * h
            minus[axis] = pos[axis] - 0.5 * h
            a_plus = self.get_coefficient(*plus)
            a_minus = self.get_coefficient(*minus)
            center = center + (a_plus + a_minus) / (h * h)
            off_p = tuple(1 if k == axis else 0 for k in range(dim))
            off_m = tuple(-1 if k == axis else 0 for k in range(dim))
            entries.append((off_p, -a_plus / (h * h)))
            entries.append((off_m, -a_minus / (h * h)))
        entries.append(((0,) * dim, center))
        return entries

    def generate_stencil(self, grid):
        return constant.Stencil(
            [(o, float(v)) for o, v in self._entries_at(self.position, grid.spacing)]
        )

    def generate_coefficient_arrays(self, grid):
        """Return (offsets, list of numpy planes over interior nodes)."""
        dim = grid.dimension
        spacing = grid.spacing
        axes = [
            (np.arange(1, grid.size[a]) * spacing[a]) for a in range(dim)
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        offsets = []
        planes = []
        center = 0.0
        for axis in range(dim):
            h = spacing[axis]
            plus = [m.copy() for m in mesh]
            minus = [m.copy() for m in mesh]
            plus[axis] = mesh[axis] + 0.5 * h
            minus[axis] = mesh[axis] - 0.5 * h
            a_plus = self.get_coefficient(*plus)
            a_minus = self.get_coefficient(*minus)
            center = center + (a_plus + a_minus) / (h * h)
            offsets.append(tuple(1 if k == axis else 0 for k in range(dim)))
            planes.append(-a_plus / (h * h))
            offsets.append(tuple(-1 if k == axis else 0 for k in range(dim)))
            planes.append(-a_minus / (h * h))
        offsets.append((0,) * dim)
        planes.append(center)
        return tuple(offsets), planes


class Poisson2DVariableCoefficients(_VariableCoefficientPoisson):
    def __init__(self, coefficient_function=default_coefficient_2d, position=(0.5, 0.5)):
        super().__init__(coefficient_function, position)


class Poisson3DVariableCoefficients(_VariableCoefficientPoisson):
    def __init__(self, coefficient_function=default_coefficient_3d, position=(0.5, 0.5, 0.5)):
        super().__init__(coefficient_function, position)


def multilinear_interpolation_stencil(dimension: int) -> constant.Stencil:
    """Tensor-product hat weights: ∏(1 - |o|/2) for o ∈ {-1,0,1}^d.

    Acts on a fine-grid field holding injected coarse values (the
    injection+stencil factorization lfa_lab uses; reference gallery.py:188-203).
    """
    entries = []
    for offset in itertools.product((-1, 0, 1), repeat=dimension):
        w = 1.0
        for o in offset:
            w *= 1.0 - abs(o) / 2.0
        entries.append((offset, w))
    return constant.Stencil(entries)


def full_weighting_restriction_stencil(dimension: int) -> constant.Stencil:
    """Full-weighting = multilinear interpolation scaled by 2^-d
    (reference gallery.py:205-219)."""
    return constant.scale(
        0.5**dimension, multilinear_interpolation_stencil(dimension)
    )


def injection_restriction_stencil(dimension: int) -> constant.Stencil:
    return constant.identity(dimension)


class MultilinearInterpolationGenerator(StencilGenerator):
    def __init__(self, coarsening_factor: Tuple[int, ...]):
        self.coarsening_factor = tuple(coarsening_factor)

    def generate_stencil(self, grid):
        return multilinear_interpolation_stencil(grid.dimension)


class FullWeightingRestrictionGenerator(StencilGenerator):
    def __init__(self, coarsening_factor: Tuple[int, ...]):
        self.coarsening_factor = tuple(coarsening_factor)

    def generate_stencil(self, grid):
        return full_weighting_restriction_stencil(grid.dimension)


class InjectionRestrictionGenerator(StencilGenerator):
    def __init__(self, coarsening_factor: Tuple[int, ...]):
        self.coarsening_factor = tuple(coarsening_factor)

    def generate_stencil(self, grid):
        return injection_restriction_stencil(grid.dimension)


class IdentityGenerator(StencilGenerator):
    def __init__(self, dimension: int):
        self.dimension = dimension

    def generate_stencil(self, grid):
        return constant.identity(self.dimension)


class ZeroGenerator(StencilGenerator):
    def __init__(self, dimension: int):
        self.dimension = dimension

    def generate_stencil(self, grid):
        return constant.null(self.dimension)
