"""Smoother application on torch tensors (counterpart of
evostencils_tpu/ops/smoothers.py).

  * decoupled Jacobi   — per-field reciprocal of the operator diagonal,
  * collective Jacobi  — per-gridpoint n_fields×n_fields solve,
  * collective block Jacobi — per-block dense solve over a small spatial
    window with a precomputed inverse (BlockSolveSpec).

The small dense inverses are computed with numpy at lowering time; at run
time only elementwise ops and one batched matmul remain.

On a slab of a grid split by rows (parallel/mesh.py) the point smoothers
are elementwise and need nothing; the block solve reads up to period−1
rows across the slab's edge, so it takes that many halo rows, tiles its
coefficient planes from the slab's global row, and its matmul form solves
the whole blocks that cover the slab and keeps the slab's rows.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from evostencils_torch import dtype_is_complex, numpy_dtype
from evostencils_torch.ops.stencil_ops import scalar
from evostencils_torch.parallel.mesh import halo_exchange
from evostencils_torch.stencils import periodic


def decoupled_jacobi_apply(r_fields: Sequence[torch.Tensor], inv_diags) -> Tuple[torch.Tensor, ...]:
    """corr_i = r_i / diag(A_ii); inv_diags are scalars or coefficient planes."""
    return tuple(inv * r for inv, r in zip(inv_diags, r_fields))


def collective_jacobi_apply(
    r_fields: Sequence[torch.Tensor], inv_center: np.ndarray
) -> Tuple[torch.Tensor, ...]:
    """Per-gridpoint solve of the constant n×n center-coefficient matrix."""
    n = len(r_fields)
    out = []
    for i in range(n):
        acc = None
        for j in range(n):
            coeff = scalar(inv_center[i, j])
            if coeff == 0.0:
                continue
            term = coeff * r_fields[j]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(r_fields[i]))
    return tuple(out)


def collective_jacobi_apply_variable(
    r_fields: Sequence[torch.Tensor], inv_center_planes
) -> Tuple[torch.Tensor, ...]:
    """Variable-coefficient collective Jacobi: inv_center_planes[i][j] is a
    tensor plane, or None for a structurally zero coupling."""
    n = len(r_fields)
    out = []
    for i in range(n):
        acc = None
        for j in range(n):
            plane = inv_center_planes[i][j]
            if plane is None:
                continue
            term = plane * r_fields[j]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(r_fields[i]))
    return tuple(out)


def _shift(r: torch.Tensor, d: Tuple[int, ...]) -> torch.Tensor:
    """out[x] = r[x + d], zero-filled outside the array."""
    if all(da == 0 for da in d):
        return r
    src = tuple(slice(max(da, 0), n + min(da, 0)) for da, n in zip(d, r.shape))
    pads = []
    for da in reversed(d):
        pads += [max(-da, 0), max(da, 0)]
    return F.pad(r[src], pads)


class BlockSolveSpec:
    """Precomputed data for a collective block-Jacobi local solve.

    The interior of every field is tiled by an anchor period `period`
    (elementwise lcm of all per-field block shapes).  The local matrix L
    couples all fields × period cells; rows of padded cells are identity.
    `inv_l` is L^{-1} (numpy, computed once at lowering time).

    Two run-time forms of the same product, as in the reference:
    ``apply_masked`` sums full-array shifts weighted by period-tiled
    coefficient planes, ``apply_matmul`` gathers blocks and multiplies by
    L^{-1} in one batched matmul."""

    def __init__(self, period: Tuple[int, ...], n_fields: int, inv_l: np.ndarray, dtype, device):
        self.period = tuple(period)
        self.n_fields = n_fields
        self.inv_l = np.asarray(inv_l, dtype=numpy_dtype(dtype))
        self.inv_l_device = torch.from_numpy(self.inv_l).to(device)
        self.block_dofs = int(np.prod(period))
        self._tiled = {}
        self._build_shift_planes()

    def _build_shift_planes(self):
        """Group L^{-1} entries by inter-field pair and displacement d:
        shift_planes[(i, j)][d] is a `period`-shaped coefficient array."""
        period = self.period
        cells = list(np.ndindex(*period))
        cell_index = {c: k for k, c in enumerate(cells)}
        nc = len(cells)
        self.shift_planes = {}
        for i in range(self.n_fields):
            for j in range(self.n_fields):
                by_d = {}
                for alpha in cells:
                    for beta in cells:
                        v = self.inv_l[i * nc + cell_index[alpha], j * nc + cell_index[beta]]
                        if v == 0:
                            continue
                        d = tuple(b - a for a, b in zip(alpha, beta))
                        plane = by_d.get(d)
                        if plane is None:
                            plane = np.zeros(period, dtype=self.inv_l.dtype)
                            by_d[d] = plane
                        plane[alpha] = v
                if by_d:
                    self.shift_planes[(i, j)] = by_d

    def _periodic_plane(self, key, plane: np.ndarray, shape, device, row_offset=0) -> torch.Tensor:
        """Full-shape tensor with value plane[x mod period], x the global
        index (a slab's rows start at global row `row_offset`), made once per
        (plane, shape, device, row phase) and kept."""
        phase = row_offset % self.period[0]
        cache_key = (key, tuple(shape), str(device), phase)
        tiled = self._tiled.get(cache_key)
        if tiled is None:
            extent = (shape[0] + phase,) + tuple(shape[1:])
            reps = [-(-n // p) for n, p in zip(extent, self.period)]
            full = np.tile(plane, reps)[(slice(phase, extent[0]),)
                                        + tuple(slice(0, n) for n in shape[1:])]
            tiled = torch.from_numpy(np.ascontiguousarray(full)).to(device)
            self._tiled[cache_key] = tiled
        return tiled

    def apply(self, r_fields: Sequence[torch.Tensor], slab=None) -> Tuple[torch.Tensor, ...]:
        """The reference's dispatch rule, kept so that parity compares the
        same arithmetic: a period trivial along the last axis takes the
        matmul form, any other the masked form."""
        if self.period[-1] == 1:
            return self.apply_matmul(r_fields, slab)
        return self.apply_masked(r_fields, slab)

    def apply_masked(self, r_fields: Sequence[torch.Tensor], slab=None) -> Tuple[torch.Tensor, ...]:
        shape = tuple(r_fields[0].shape)
        device = r_fields[0].device
        halo = self.period[0] - 1
        if slab is None or halo == 0:
            def shifted(j, d):
                return _shift(r_fields[j], d)
        else:
            # Shifts within a block reach at most period−1 rows across the
            # slab's edge: shift the halo'd rows and keep the slab's.
            padded = [halo_exchange(r, slab, halo) for r in r_fields]

            def shifted(j, d):
                return _shift(padded[j], d)[halo:halo + shape[0]]
        row_offset = 0 if slab is None else slab.lo
        out = []
        for i in range(self.n_fields):
            acc = None
            for j in range(self.n_fields):
                by_d = self.shift_planes.get((i, j))
                if not by_d:
                    continue
                for d, plane in by_d.items():
                    vals = plane[plane != 0]
                    if vals.size and np.all(vals == vals.flat[0]) and not np.any(plane == 0):
                        # Uniform plane: scalar weight, no masking at all.
                        term = scalar(vals.flat[0]) * shifted(j, d)
                    else:
                        coeffs = self._periodic_plane((i, j, d), plane, shape, device, row_offset)
                        term = coeffs * shifted(j, d)
                    acc = term if acc is None else acc + term
            out.append(acc if acc is not None else torch.zeros_like(r_fields[i]))
        return tuple(out)

    def apply_matmul(self, r_fields: Sequence[torch.Tensor], slab=None) -> Tuple[torch.Tensor, ...]:
        if slab is not None and self.period[0] > 1:
            # The whole blocks that cover the slab: global rows [a, b), a
            # and b on the period, at most period−1 rows beyond the slab on
            # either side (zero past the grid's edge, as the padding of the
            # whole grid); solve them and keep the slab's rows.
            p0, halo = self.period[0], self.period[0] - 1
            a = slab.lo // p0 * p0
            b = -(-slab.hi // p0) * p0
            start = a - (slab.lo - halo)
            blocks = [halo_exchange(r, slab, halo)[start:start + b - a] for r in r_fields]
            solved = self.apply_matmul(blocks)
            return tuple(x[slab.lo - a:slab.hi - a] for x in solved)
        period = self.period
        shape = tuple(r_fields[0].shape)
        dim = len(shape)
        padded_shape = tuple(-(-n // p) * p for n, p in zip(shape, period))
        blocks_per_axis = tuple(ps // p for ps, p in zip(padded_shape, period))
        n_blocks = int(np.prod(blocks_per_axis))
        perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))

        cols = []
        for r in r_fields:
            pads = []
            for ps, n in zip(reversed(padded_shape), reversed(shape)):
                pads += [0, ps - n]
            rp = F.pad(r, pads)
            # (B0, p0, B1, p1, ...) -> (B0, B1, ..., p0, p1, ...)
            interleaved = rp.reshape(tuple(x for bp in zip(blocks_per_axis, period) for x in bp))
            cols.append(interleaved.permute(perm).reshape(n_blocks, self.block_dofs))
        rhs = torch.cat(cols, dim=1)  # (n_blocks, n_fields*block_dofs)
        sol = torch.matmul(rhs, self.inv_l_device.T)
        inv_perm = []
        for axis in range(dim):
            inv_perm.extend([axis, dim + axis])
        out = []
        for i in range(self.n_fields):
            piece = sol[:, i * self.block_dofs:(i + 1) * self.block_dofs]
            piece = piece.reshape(blocks_per_axis + period)
            unblocked = piece.permute(tuple(inv_perm)).reshape(padded_shape)
            out.append(unblocked[tuple(slice(0, n) for n in shape)])
        return tuple(out)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def build_block_solve_spec(
    smoothing_operator_entries,
    block_sizes: Sequence[Tuple[int, ...]],
    interior_shape: Tuple[int, ...],
    dtype,
    device,
) -> BlockSolveSpec:
    """Assemble and invert the local block matrix.

    smoothing_operator_entries[i][j]: periodic stencil of the (already
    block-diagonal-filtered) coupling from field j to field i.
    """
    n_fields = len(smoothing_operator_entries)
    dim = len(interior_shape)
    period = tuple(
        reduce(_lcm, (bs[axis] for bs in block_sizes), 1) for axis in range(dim)
    )
    cells = list(np.ndindex(*period))
    cell_index = {c: k for k, c in enumerate(cells)}
    n_cell = len(cells)
    n = n_fields * n_cell
    L = np.zeros((n, n), dtype=np.complex128)
    for i in range(n_fields):
        for j in range(n_fields):
            stencil = periodic.lift(smoothing_operator_entries[i][j])
            if stencil is None:
                continue
            for alpha in cells:
                cell_stencil = stencil[alpha]
                if cell_stencil is None:
                    continue
                row = i * n_cell + cell_index[alpha]
                for offset, value in cell_stencil.entries:
                    # Block-diagonal filtering keeps alpha+offset inside the
                    # block; couplings that would leave it are dropped.
                    target = tuple(a + o for a, o in zip(alpha, offset))
                    if any(t < 0 or t >= p for t, p in zip(target, period)):
                        continue
                    L[row, j * n_cell + cell_index[target]] += value
    # Identity rows for structurally empty equations keep L invertible.
    for row in range(n):
        if not np.any(L[row, :]):
            L[row, row] = 1.0
    inv_l = np.linalg.inv(L)
    if not dtype_is_complex(dtype):
        inv_l = np.real(inv_l)
    return BlockSolveSpec(period, n_fields, inv_l, dtype, device)
