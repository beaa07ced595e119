"""A 2D vertex-centred grid hierarchy with homogeneous Dirichlet boundaries
and the operators a cycle uses on it, in plain PyTorch.

Level L has (2^L - 1)^2 interior nodes, spacing h = 2^-L.  Coarse node i
sits on fine node 2i + 1.  The operator on every level is the 5-point
stencil -Δ_h - s·k² (Poisson: k = 0), rediscretised per level:
centre 4/h² - s·k², neighbours -1/h².  Restriction is full weighting
(1/16 [1 2 1; 2 4 2; 1 2 1]), prolongation bilinear interpolation.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


class Level:
    """One grid level: its size and its operator's coefficients."""

    def __init__(self, level: int, shift_k2: complex = 0.0):
        self.level = level
        self.n = 2 ** level - 1
        inv_h2 = float(4 ** level)
        self.centre = 4.0 * inv_h2 - shift_k2
        self.off = -inv_h2

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """A·u with zeros outside the interior."""
        p = F.pad(u, (1, 1, 1, 1))
        neighbours = p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2] + p[..., 1:-1, 2:]
        return self.centre * u + self.off * neighbours

    def residual(self, u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return f - self.apply(u)


def restrict(fine: torch.Tensor) -> torch.Tensor:
    """Full weighting onto the coarse nodes, one axis after the other."""
    rows = 0.25 * fine[..., 0:-2:2, :] + 0.5 * fine[..., 1:-1:2, :] + 0.25 * fine[..., 2::2, :]
    return 0.25 * rows[..., 0:-2:2] + 0.5 * rows[..., 1:-1:2] + 0.25 * rows[..., 2::2]


def _interpolate_last(c: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along the last axis: n -> 2n + 1 nodes."""
    padded = F.pad(c, (1, 1))
    between = 0.5 * (padded[..., :-1] + padded[..., 1:])  # n + 1 even nodes
    out = torch.stack((between[..., :-1], c), dim=-1).flatten(-2)
    return torch.cat((out, between[..., -1:]), dim=-1)


def prolong(coarse: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation to the fine nodes."""
    cols = _interpolate_last(coarse)
    return _interpolate_last(cols.transpose(-1, -2)).transpose(-1, -2)


def red_black_masks(n: int, dtype, device):
    """(red, black): red where i + j is even, 0-based interior indices."""
    i = torch.arange(n, device=device)
    parity = (i[:, None] + i[None, :]) % 2
    return tuple((parity == c).to(dtype) for c in (0, 1))


def assemble(level: Level, dtype, device) -> torch.Tensor:
    """The level's operator as a dense matrix (row-major node order)."""
    n = level.n
    size = n * n
    eye = torch.eye(size, dtype=dtype, device=device).reshape(size, n, n)
    return level.apply(eye).reshape(size, size).T.contiguous()


@functools.lru_cache(maxsize=None)
def _block_inverse_cached(centre: complex, off: float, block: tuple, dtype, device: str):
    b0, b1 = block
    cells = b0 * b1
    local = torch.zeros(cells, cells, dtype=torch.complex128)
    for a in range(b0):
        for b in range(b1):
            row = a * b1 + b
            local[row, row] = centre
            for da, db in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                x, y = a + da, b + db
                if 0 <= x < b0 and 0 <= y < b1:
                    local[row, x * b1 + y] = off
    inverse = torch.linalg.inv(local)
    if not dtype.is_complex:
        inverse = inverse.real
    return inverse.to(dtype=dtype, device=device)


def block_jacobi_correction(level: Level, r: torch.Tensor, block: tuple) -> torch.Tensor:
    """B⁻¹·r for non-overlapping blocks of shape `block` anchored at the
    first interior node; B keeps the operator's couplings inside a block.
    A block that reaches past the last interior node keeps its whole local
    matrix, with zero residual on the nodes outside."""
    b0, b1 = block
    n = level.n
    m0, m1 = -(-n // b0), -(-n // b1)
    padded = F.pad(r, (0, m1 * b1 - n, 0, m0 * b0 - n))
    blocks = padded.reshape(m0, b0, m1, b1).permute(0, 2, 1, 3).reshape(m0 * m1, b0 * b1)
    inverse = _block_inverse_cached(complex(level.centre), float(level.off), tuple(block),
                                    r.dtype, str(r.device))
    solved = blocks @ inverse.T
    out = solved.reshape(m0, m1, b0, b1).permute(0, 2, 1, 3).reshape(m0 * b0, m1 * b1)
    return out[:n, :n]


def dirac_pulse(level: int, dtype, device) -> torch.Tensor:
    """The B-spline hat approximation of δ(x - 1/2, y - 1/2) on the interior
    nodes: g(x)·g(y), g(c) = max(0, (h - |c - 1/2|) / h²)."""
    n = 2 ** level
    h = 1.0 / n
    c = torch.arange(1, n, dtype=torch.float64) / n
    g = torch.clamp((h - torch.abs(c - 0.5)) / h ** 2, min=0.0)
    return (g[:, None] * g[None, :]).to(dtype=dtype, device=device)
