"""Stencil application on torch tensors (counterpart of
evostencils_tpu/ops/stencil_ops.py).

Grid functions are dense tensors over the interior nodes of a structured
grid with homogeneous Dirichlet boundaries.  A constant stencil is a sum of
shifted views of the zero-padded field, summed in the stencil's entry order
as the reference does; a variable-coefficient stencil is the same sum with
one coefficient plane per offset in place of the scalar.  Plain torch: the
only hand-written kernel on these paths is the fused red-black sweep
(ops/rb_sweep.py), which takes constant 2D stencils only.

Every op that reads across rows or by position takes an optional `slab`
(parallel/mesh.py): the field is then this rank's rows of a grid split
over a device mesh.  The row halo comes from `halo_exchange` in place of
the zero rows, colour and period masks start at the slab's global row, and
sums are all-reduced before a norm is taken.  `slab=None` is the whole
grid on one device.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from evostencils_torch.parallel.mesh import halo_exchange
from evostencils_torch.stencils import constant, periodic


def scalar(value):
    """A stencil or matrix coefficient as a Python number: torch then
    keeps the field's precision, as the reference's weak-typed scalars do
    (a Python complex times a complex64 tensor stays complex64; times a
    real tensor it promotes to the complex dtype of the same width)."""
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


def pad(u: torch.Tensor, reach: Tuple[int, ...], slab=None) -> torch.Tensor:
    """The field with its halo: zeros on a whole grid; on a slab the rows
    above and below from the ranks that own them (zeros at the grid's
    boundary) and zero columns."""
    if slab is None:
        return pad_zeros(u, reach)
    return pad_zeros(halo_exchange(u, slab, reach[0]), (0,) + tuple(reach[1:]))


def shifted_view(padded: torch.Tensor, offset, reach, shape) -> torch.Tensor:
    index = tuple(slice(r + o, r + o + n) for r, o, n in zip(reach, offset, shape))
    return padded[index]


def apply_constant_stencil(u: torch.Tensor, stencil: constant.Stencil, slab=None) -> torch.Tensor:
    """y[x] = Σ_o v_o · u[x+o], u extended by zero outside the interior."""
    if stencil.number_of_entries == 0:
        return torch.zeros_like(u)
    reach = stencil.max_reach()
    padded = pad(u, reach, slab)
    shape = u.shape
    out = None
    for offset, value in stencil.entries:
        term = scalar(value) * shifted_view(padded, offset, reach, shape)
        out = term if out is None else out + term
    return out


def variable_reach(offsets) -> Tuple[int, ...]:
    """Per-axis reach of a variable stencil's offsets."""
    return tuple(max(abs(o[a]) for o in offsets) for a in range(len(offsets[0])))


def apply_variable_stencil(u: torch.Tensor, offsets, planes, slab=None) -> torch.Tensor:
    """Variable-coefficient stencil: y[x] = Σ_o p_o[x] · u[x+o], one
    coefficient plane per offset (on a slab, the slab's rows of it), summed
    in offset order."""
    reach = variable_reach(offsets)
    padded = pad(u, reach, slab)
    shape = u.shape
    out = None
    for offset, plane in zip(offsets, planes):
        term = plane * shifted_view(padded, offset, reach, shape)
        out = term if out is None else out + term
    return out


def parity_masks(shape: Tuple[int, ...], period: Tuple[int, ...], dtype, device, row_offset=0):
    """All per-cell masks of a period lattice, as a dict index -> mask, on
    interior coordinates (as the reference); `row_offset` is the global row
    of a slab's first row."""
    grids = [(np.arange(n) + (row_offset if axis == 0 else 0)) % p
             for axis, (n, p) in enumerate(zip(shape, period))]
    mesh = np.meshgrid(*grids, indexing="ij")
    masks = {}
    for index in np.ndindex(*period):
        m = np.ones(shape, dtype=bool)
        for axis in range(len(shape)):
            m &= mesh[axis] == index[axis]
        masks[index] = torch.from_numpy(m).to(device=device, dtype=dtype)
    return masks


@functools.lru_cache(maxsize=None)
def red_black_masks(shape: Tuple[int, ...], dtype, device, row_parity=0):
    """(red, black) checkerboard masks: red = even global index sum; a slab
    whose first row is odd (`row_parity` 1) starts on black.  Cached per
    (shape, dtype, device, row_parity); callers never modify them."""
    grids = [np.arange(n) + (row_parity if axis == 0 else 0) for axis, n in enumerate(shape)]
    s = sum(np.meshgrid(*grids, indexing="ij")) % 2
    return tuple(torch.from_numpy(s == c).to(device=device, dtype=dtype) for c in (0, 1))


def apply_periodic_stencil(u: torch.Tensor, stencil: periodic.PeriodicStencil,
                           slab=None) -> torch.Tensor:
    """Apply a block-varying stencil by masked superposition of its cells."""
    if stencil.is_uniform():
        return apply_constant_stencil(u, stencil.as_constant(), slab)
    masks = parity_masks(tuple(u.shape), stencil.period, u.dtype, u.device,
                         0 if slab is None else slab.lo)
    out = torch.zeros_like(u)
    for index in np.ndindex(*stencil.period):
        cell = stencil.cells[index]
        if cell is None or cell.number_of_entries == 0:
            continue
        out = out + masks[index] * apply_constant_stencil(u, cell, slab)
    return out


def apply_stencil(u: torch.Tensor, stencil, slab=None) -> torch.Tensor:
    if isinstance(stencil, constant.Stencil):
        return apply_constant_stencil(u, stencil, slab)
    if isinstance(stencil, periodic.PeriodicStencil):
        return apply_periodic_stencil(u, stencil, slab)
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


def numpy_apply_variable_stencil(u: np.ndarray, offsets, planes) -> np.ndarray:
    """Host-side variable-coefficient stencil in the array's own dtype
    (the exact residual of a variable operator between restarted stages)."""
    reach = variable_reach(offsets)
    padded = np.pad(u, [(r, r) for r in reach])
    out = np.zeros_like(u)
    for offset, plane in zip(offsets, planes):
        index = tuple(slice(r + o, r + o + n) for r, o, n in zip(reach, offset, u.shape))
        out += np.asarray(plane, dtype=u.dtype) * padded[index]
    return out


def _all_reduced(acc: torch.Tensor, slab) -> torch.Tensor:
    return acc if slab is None else slab.layout.all_reduce_sum(acc)


def l2_norm(fields: Sequence[torch.Tensor], slab=None) -> torch.Tensor:
    """Euclidean norm over all fields of a system state (0-dim real
    tensor; Σ real(f·conj f) for complex fields); on slabs the sum of every
    rank's sums."""
    acc = None
    for f in fields:
        s = torch.sum(torch.real(f * torch.conj(f))) if f.is_complex() else torch.sum(f * f)
        acc = s if acc is None else acc + s
    return torch.sqrt(_all_reduced(acc, slab))


def dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], slab=None) -> torch.Tensor:
    """Σ conj(x)·y over all fields: the conjugate is on the first argument;
    on slabs the sum of every rank's sums."""
    acc = None
    for x, y in zip(a, b):
        s = torch.sum(torch.conj(x) * y) if x.is_complex() else torch.sum(x * y)
        acc = s if acc is None else acc + s
    return _all_reduced(acc, slab)


def tree_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def tree_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def tree_scale(factor, a):
    return tuple(factor * x for x in a)


def zeros_like_state(state):
    return tuple(torch.zeros_like(x) for x in state)
