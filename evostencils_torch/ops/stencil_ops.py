"""Stencil application on torch tensors (counterpart of
evostencils_tpu/ops/stencil_ops.py).

Grid functions are dense tensors over the interior nodes of a structured
grid with homogeneous Dirichlet boundaries.  A constant stencil is a sum of
shifted views of the zero-padded field, summed in the stencil's entry order
as the reference does.  Plain torch: the only hand-written kernel on this
path is the fused red-black sweep (ops/rb_sweep.py).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from evostencils_torch.stencils import constant, periodic


def scalar(value):
    """A stencil or matrix coefficient as a Python number: torch then
    keeps the field's dtype, as the reference's weak-typed scalars do."""
    value = complex(value)
    return value.real if value.imag == 0.0 else value


def pad_zeros(u: torch.Tensor, reach: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad by the stencil reach (homogeneous Dirichlet halo)."""
    if all(r == 0 for r in reach):
        return u
    pads = []
    for r in reversed(reach):
        pads += [r, r]
    return F.pad(u, pads)


def shifted_view(padded: torch.Tensor, offset, reach, shape) -> torch.Tensor:
    index = tuple(slice(r + o, r + o + n) for r, o, n in zip(reach, offset, shape))
    return padded[index]


def apply_constant_stencil(u: torch.Tensor, stencil: constant.Stencil) -> torch.Tensor:
    """y[x] = Σ_o v_o · u[x+o], u extended by zero outside the interior."""
    if stencil.number_of_entries == 0:
        return torch.zeros_like(u)
    reach = stencil.max_reach()
    padded = pad_zeros(u, reach)
    shape = u.shape
    out = None
    for offset, value in stencil.entries:
        term = scalar(value) * shifted_view(padded, offset, reach, shape)
        out = term if out is None else out + term
    return out


def parity_masks(shape: Tuple[int, ...], period: Tuple[int, ...], dtype, device):
    """All per-cell masks of a period lattice, as a dict index -> mask, on
    local interior coordinates (as the reference)."""
    grids = [np.arange(n) % p for n, p in zip(shape, period)]
    mesh = np.meshgrid(*grids, indexing="ij")
    masks = {}
    for index in np.ndindex(*period):
        m = np.ones(shape, dtype=bool)
        for axis in range(len(shape)):
            m &= mesh[axis] == index[axis]
        masks[index] = torch.from_numpy(m).to(device=device, dtype=dtype)
    return masks


@functools.lru_cache(maxsize=None)
def red_black_masks(shape: Tuple[int, ...], dtype, device):
    """(red, black) checkerboard masks: red = even local index sum.
    Cached per (shape, dtype, device); callers never modify them."""
    grids = [np.arange(n) for n in shape]
    s = sum(np.meshgrid(*grids, indexing="ij")) % 2
    return tuple(torch.from_numpy(s == c).to(device=device, dtype=dtype) for c in (0, 1))


def apply_periodic_stencil(u: torch.Tensor, stencil: periodic.PeriodicStencil) -> torch.Tensor:
    """Apply a block-varying stencil by masked superposition of its cells."""
    if stencil.is_uniform():
        return apply_constant_stencil(u, stencil.as_constant())
    masks = parity_masks(tuple(u.shape), stencil.period, u.dtype, u.device)
    out = torch.zeros_like(u)
    for index in np.ndindex(*stencil.period):
        cell = stencil.cells[index]
        if cell is None or cell.number_of_entries == 0:
            continue
        out = out + masks[index] * apply_constant_stencil(u, cell)
    return out


def apply_stencil(u: torch.Tensor, stencil) -> torch.Tensor:
    if isinstance(stencil, constant.Stencil):
        return apply_constant_stencil(u, stencil)
    if isinstance(stencil, periodic.PeriodicStencil):
        return apply_periodic_stencil(u, stencil)
    raise TypeError(f"Not a stencil: {type(stencil)}")


def numpy_apply_constant_stencil(u: np.ndarray, stencil: constant.Stencil) -> np.ndarray:
    """Host-side stencil application in the array's own dtype (float64 for
    the exact residuals between restarted f32 stages)."""
    if stencil.number_of_entries == 0:
        return np.zeros_like(u)
    reach = stencil.max_reach()
    padded = np.pad(u, [(r, r) for r in reach])
    out = np.zeros_like(u)
    for offset, value in stencil.entries:
        index = tuple(slice(r + o, r + o + n) for r, o, n in zip(reach, offset, u.shape))
        out += value * padded[index]
    return out


def l2_norm(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """Euclidean norm over all fields of a system state (0-dim tensor)."""
    acc = None
    for f in fields:
        s = torch.sum(f * f)
        acc = s if acc is None else acc + s
    return torch.sqrt(acc)


def dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = None
    for x, y in zip(a, b):
        s = torch.sum(x * y)
        acc = s if acc is None else acc + s
    return acc


def tree_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def tree_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def tree_scale(factor, a):
    return tuple(factor * x for x in a)

