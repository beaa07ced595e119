"""Stencil application on torch tensors (counterpart of
evostencils_tpu/ops/stencil_ops.py).

Grid functions are dense tensors over the interior nodes of a structured
grid with homogeneous Dirichlet boundaries.  A constant stencil is a sum of
shifted views of the zero-padded field, summed in the stencil's entry order
as the reference does; a variable-coefficient stencil is the same sum with
one coefficient plane per offset in place of the scalar.  A real constant
2D stencil on a CUDA tensor is one launch of the stencil kernel
(ops/stencil_kernel.py), which gives the plain sum's bits; everything else
is plain torch, apart from the fused red-black sweep (ops/rb_sweep.py).

Every op that reads across rows or by position takes an optional `slab`
(parallel/mesh.py): the field is then this rank's rows of a grid split
over a device mesh.  The row halo comes from `halo_exchange` in place of
the zero rows, colour and period masks start at the slab's global row, and
sums are all-reduced before a norm is taken.  `slab=None` is the whole
grid on one device.

A state with members (the group path's batch of same-structure cycles,
backend/evaluation.py) holds each field as one tensor of shape (B, *grid):
the grid is always the trailing axes, as many as the stencil's or the
grid's dimension, and every op indexes those, so a member's values are the
single-member op's on that member, bit for bit.  `members=True` makes a
norm or an inner product one value per member, shape (B,), each summed
over its own elements.  A mesh slab takes no members.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from evostencils_torch.ops import stencil_kernel
from evostencils_torch.parallel.mesh import halo_exchange
from evostencils_torch.stencils import constant, periodic


def scalar(value):
    """A stencil or matrix coefficient as a Python number: torch then
    keeps the field's precision, as the reference's weak-typed scalars do
    (a Python complex times a complex64 tensor stays complex64; times a
    real tensor it promotes to the complex dtype of the same width)."""
    value = complex(value)
    return value.real if value.imag == 0.0 else value


def grid_shape(u: torch.Tensor, dimension: int) -> Tuple[int, ...]:
    """The grid's shape: the trailing `dimension` axes of a field, with
    members or without."""
    return tuple(u.shape[u.dim() - dimension:])


def member_shape(u: torch.Tensor, dimension: int) -> Tuple[int, ...]:
    """The leading member axes of a field on a `dimension`-D grid: () for
    a single member."""
    return tuple(u.shape[:u.dim() - dimension])


def pad_zeros(u: torch.Tensor, reach: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the trailing axes by the stencil reach (homogeneous
    Dirichlet halo)."""
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
    """The window of the padded grid shifted by `offset`, on the trailing
    axes."""
    index = tuple(slice(r + o, r + o + n) for r, o, n in zip(reach, offset, shape))
    return padded[(Ellipsis,) + index]


def apply_constant_stencil(u: torch.Tensor, stencil: constant.Stencil, slab=None) -> torch.Tensor:
    """y[x] = Σ_o v_o · u[x+o], u extended by zero outside the interior:
    one launch of the stencil kernel where its gate takes the call
    (ops/stencil_kernel.py), the same bits as the plain sum."""
    if stencil_kernel.check(u, stencil, slab):
        return stencil_kernel.apply(u, stencil)
    return plain_constant_stencil(u, stencil, slab)


def plain_constant_stencil(u: torch.Tensor, stencil: constant.Stencil, slab=None) -> torch.Tensor:
    """The plain sum of shifted views of the padded field: one multiply an
    entry and one add each after the first."""
    if stencil.number_of_entries == 0:
        return torch.zeros_like(u)
    reach = stencil.max_reach()
    padded = pad(u, reach, slab)
    shape = grid_shape(u, len(reach))
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
    shape = grid_shape(u, len(reach))
    out = None
    for offset, plane in zip(offsets, planes):
        term = plane * shifted_view(padded, offset, reach, shape)
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def parity_masks(shape: Tuple[int, ...], period: Tuple[int, ...], dtype, device, row_offset=0):
    """All per-cell masks of a period lattice, as a dict index -> mask, on
    interior coordinates (as the reference); `row_offset` is the global row
    of a slab's first row.  Cached, as red_black_masks: a cycle captured in
    a CUDA graph finds them on the device and copies nothing from the host;
    callers never modify them."""
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
    masks = parity_masks(grid_shape(u, stencil.dimension), stencil.period, u.dtype, u.device,
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


def _in_range(offset, shape):
    """(points, neighbours): the slices of the points whose neighbour at
    `offset` lies inside the grid, and of those neighbours (empty where
    |offset| reaches past the grid)."""
    points = tuple(slice(min(n, max(0, -o)), max(0, n - max(0, o)))
                   for o, n in zip(offset, shape))
    neighbours = tuple(slice(min(n, max(0, o)), max(0, n + min(0, o)))
                       for o, n in zip(offset, shape))
    return points, neighbours


# Bytes of the leading rows the host applies a constant stencil to at once:
# a block stays in the core's cache through every entry and the residual's
# subtraction, where whole grids (2 MB at 511², float64) go out to memory
# and back with each pass.
_HOST_BLOCK_BYTES = 1 << 18


def _zero_outside(block, kept) -> None:
    """Zeros every point of `block` outside the slices `kept`."""
    for axis, inside in enumerate(kept):
        before = (slice(None),) * axis
        block[before + (slice(0, inside.start),)] = 0
        block[before + (slice(inside.stop, None),)] = 0


def _host_constant_stencil(u: np.ndarray, stencil: constant.Stencil, f=None) -> np.ndarray:
    """A·u, or f − A·u with `f`, into a fresh array in u's dtype, a block
    of leading rows at a time.

    No padded copy: each entry multiplies the in-range neighbours into one
    scratch buffer and adds them into the matching points, in the stencil's
    order, a point's first product onto +0.0.  That is the zero-padded sum
    to the bit: a neighbour outside the grid would add value·0.0, which
    changes no bit of a sum started from +0.0.  The blocks change no sum:
    a point's entries are added in the same order in any block."""
    out = np.empty_like(u)
    rows = max(1, _HOST_BLOCK_BYTES // max(1, u[:1].nbytes))
    scratch = np.empty(min(rows, len(u)) * u[:1].size, u.dtype)
    entries = [(offset[0], value) + _in_range(offset, u.shape)
               for offset, value in stencil.entries]
    for r0 in range(0, len(u), rows):
        r1 = min(len(u), r0 + rows)
        block = out[r0:r1]
        started = False
        for shift, value, points, neighbours in entries:
            lo, hi = max(points[0].start, r0), min(points[0].stop, r1)
            if lo >= hi:
                continue
            kept = (slice(lo - r0, hi - r0),) + points[1:]
            target = block[kept]
            if target.size == 0:
                continue
            source = u[(slice(lo + shift, hi + shift),) + neighbours[1:]]
            if not started:
                _zero_outside(block, kept)
                np.multiply(value, source, out=target)
                np.add(target, 0.0, out=target)
                started = True
                continue
            product = scratch[:target.size].reshape(target.shape)
            np.multiply(value, source, out=product)
            np.add(target, product, out=target)
        if not started:
            block.fill(0)
        if f is not None:
            np.subtract(f[r0:r1], block, out=block)
    return out


def numpy_apply_constant_stencil(u: np.ndarray, stencil: constant.Stencil) -> np.ndarray:
    """Host-side stencil application in the array's own dtype (float64 for
    the exact residuals between restarted f32 stages), into a fresh array."""
    return _host_constant_stencil(u, stencil)


def numpy_constant_residual(f: np.ndarray, u: np.ndarray, stencil: constant.Stencil) -> np.ndarray:
    """f − A·u on the host in u's dtype, into a fresh array: the bits of
    `f - numpy_apply_constant_stencil(u, stencil)`, with the subtraction
    done block by block while the block is in cache."""
    return _host_constant_stencil(u, stencil, f)


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


def numpy_l2_norm(state) -> float:
    """Euclidean norm of a host (numpy) state: one pass a field, Σ x̄·x as a
    dot product of the flattened field with itself (real for a complex
    field)."""
    return math.sqrt(sum(float(np.vdot(x, x).real) for x in state))


def _all_reduced(acc: torch.Tensor, slab) -> torch.Tensor:
    return acc if slab is None else slab.layout.all_reduce_sum(acc)


def _sum(x: torch.Tensor, members: bool) -> torch.Tensor:
    """Σ over every element, or over each member's own elements (shape
    (B,)).  On the CPU each member's sum is the single-member call on its
    block, so it gives the single sum's bits (torch splits a long reduction
    over threads, and one reduction over the member axis splits it
    otherwise); on the card one reduction over the member axis, whose order
    may differ from the single sum's in the last bits."""
    if not members:
        return torch.sum(x)
    if x.device.type == "cpu":
        return torch.stack([torch.sum(member) for member in x])
    return torch.sum(x, dim=tuple(range(1, x.dim())))


def l2_norm(fields: Sequence[torch.Tensor], slab=None, members: bool = False) -> torch.Tensor:
    """Euclidean norm over all fields of a system state (0-dim real
    tensor, or one per member; Σ real(f·conj f) for complex fields); on
    slabs the sum of every rank's sums."""
    acc = None
    for f in fields:
        s = _sum(torch.real(f * torch.conj(f)) if f.is_complex() else f * f, members)
        acc = s if acc is None else acc + s
    return torch.sqrt(_all_reduced(acc, slab))


def dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], slab=None,
        members: bool = False) -> torch.Tensor:
    """Σ conj(x)·y over all fields (one per member with `members`): the
    conjugate is on the first argument; on slabs the sum of every rank's
    sums."""
    acc = None
    for x, y in zip(a, b):
        s = _sum(torch.conj(x) * y if x.is_complex() else x * y, members)
        acc = s if acc is None else acc + s
    return _all_reduced(acc, slab)


def per_member(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) value viewed as (B, 1, …) to scale the fields shaped like
    `like`."""
    return value.view((-1,) + (1,) * (like.dim() - 1))


def tree_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def tree_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def tree_scale(factor, a):
    return tuple(factor * x for x in a)


def zeros_like_state(state):
    return tuple(torch.zeros_like(x) for x in state)
