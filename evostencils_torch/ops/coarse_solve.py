"""Coarse-grid solver: dense solve via a precomputed inverse (counterpart of
evostencils_tpu/ops/coarse_solve.py).

The coarse system matrix is assembled and inverted with numpy once, at
lowering time; at run time the solve is one `torch.matmul` (a 961×961
matvec at level 5, a 49×49 complex one at level 3 of Helmholtz).  That
product is a library call, as the reference left it to XLA.  The inverse
stays complex for a complex solver dtype and is cast to real otherwise.

A state with members, fields of shape (B, *grid), is solved member by
member with the same matrix-vector product: one product over all members
(a matrix-matrix product) would round otherwise, and B products of the
coarsest level cost little.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from evostencils_torch import dtype_is_complex, numpy_dtype
from evostencils_torch.stencils import periodic


def assemble_scalar_matrix(stencil, interior_shape: Tuple[int, ...], planes=None) -> np.ndarray:
    """Dense matrix of a constant, periodic or variable stencil operator with
    homogeneous Dirichlet boundary (couplings leaving the interior drop).
    `planes` = (offsets, coefficient planes) takes the variable branch."""
    n = int(np.prod(interior_shape))
    A = np.zeros((n, n), dtype=np.complex128)
    grids = np.meshgrid(*[np.arange(s) for s in interior_shape], indexing="ij")
    flat_index = np.ravel_multi_index([g.ravel() for g in grids], interior_shape)

    if planes is not None:
        offsets, coeff_planes = planes
        for offset, plane in zip(offsets, coeff_planes):
            target = [g.ravel() + o for g, o in zip(grids, offset)]
            valid = np.ones(n, dtype=bool)
            for t, s in zip(target, interior_shape):
                valid &= (t >= 0) & (t < s)
            rows = flat_index[valid]
            cols = np.ravel_multi_index([t[valid] for t in target], interior_shape)
            A[rows, cols] += np.asarray(plane).ravel()[valid]
        return A
    pstencil = periodic.lift(stencil)
    period = pstencil.period
    cell_of_point = sum(
        (g.ravel() % p) * int(np.prod(period[k + 1:]))
        for k, (g, p) in enumerate(zip(grids, period))
    )
    for cell_id, index in enumerate(np.ndindex(*period)):
        cell = pstencil.cells[index]
        if cell is None or cell.number_of_entries == 0:
            continue
        in_cell = cell_of_point == cell_id
        for offset, value in cell.entries:
            target = [g.ravel() + o for g, o in zip(grids, offset)]
            valid = in_cell.copy()
            for t, s in zip(target, interior_shape):
                valid &= (t >= 0) & (t < s)
            rows = flat_index[valid]
            cols = np.ravel_multi_index([t[valid] for t in target], interior_shape)
            A[rows, cols] += value
    return A


class DenseSolveSpec:
    """Precomputed dense inverse of a (block) system operator.  `inv` is the
    numpy matrix (as the reference holds it); the device copy is made once."""

    def __init__(self, inv_matrix: np.ndarray, field_shapes, dtype, device):
        self.inv = np.asarray(inv_matrix, dtype=numpy_dtype(dtype))
        self.field_shapes = [tuple(s) for s in field_shapes]
        self.sizes = [int(np.prod(s)) for s in field_shapes]
        self.inv_device = torch.from_numpy(self.inv).to(device)

    def apply(self, r_fields: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if r_fields[0].dim() > len(self.field_shapes[0]):
            solved = [self.apply(member) for member in zip(*r_fields)]
            return tuple(torch.stack(field) for field in zip(*solved))
        flat = torch.cat([r.reshape(-1) for r in r_fields])
        sol = torch.matmul(self.inv_device, flat)
        out = []
        start = 0
        for size, shape in zip(self.sizes, self.field_shapes):
            out.append(sol[start:start + size].reshape(shape))
            start += size
        return tuple(out)


def build_dense_solve_spec(entry_matrices, field_shapes, dtype, device) -> DenseSolveSpec:
    """entry_matrices[i][j]: dense numpy block (or None for zero blocks)."""
    sizes = [int(np.prod(s)) for s in field_shapes]
    n = sum(sizes)
    A = np.zeros((n, n), dtype=np.complex128)
    row0 = 0
    for i, row in enumerate(entry_matrices):
        col0 = 0
        for j, block in enumerate(row):
            if block is not None:
                A[row0:row0 + sizes[i], col0:col0 + sizes[j]] = block
            col0 += sizes[j]
        row0 += sizes[i]
    inv = np.linalg.inv(A)
    if not dtype_is_complex(dtype):
        inv = np.real(inv)
    return DenseSolveSpec(inv, field_shapes, dtype, device)
