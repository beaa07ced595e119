"""The staged solve's verdict recomputed: the relative residual of a
solution of the 5-point -Δ_h, in numpy's extended precision (float64
where the platform's longdouble is no wider)."""

from __future__ import annotations

import numpy as np


def relative_residual(u: np.ndarray, f: np.ndarray, level: int) -> float:
    """‖f - A·u‖ / ‖f‖ on `level` (spacing 2^-level, Dirichlet boundary)."""
    wide = np.longdouble
    inv_h2 = wide(4 ** level)
    f = np.asarray(f, wide)
    p = np.pad(np.asarray(u, wide), 1)
    au = 4 * inv_h2 * p[1:-1, 1:-1] - inv_h2 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2]
                                               + p[1:-1, 2:])
    r = f - au
    return float(np.sqrt(np.sum(r * r)) / np.sqrt(np.sum(f * f)))
