"""Restriction and prolongation (counterpart of evostencils_tpu/ops/intergrid.py).

Vertex-centred hierarchy with Dirichlet boundaries, as in the reference:
  * the fine grid of level l has interior nodes 1..2^l-1 per axis,
  * coarse node `ci` (local) coincides with fine local node `c*(ci+1)-1`
    for coarsening factor c (c=2: the odd fine indices).

Restriction is the stencil on the fine grid read at the coarse lattice,
computed as strided views of the zero-padded fine field; prolongation
injects the coarse values into a zero fine field and applies the stencil.
On the card a real 2D stencil takes one launch of the stencil kernel for
either (ops/stencil_kernel.py), with the same bits.
The reference's per-axis factor matrices and conv tiers are TPU layout
choices and have no counterpart here.

With a `slab` (the fine grid's rows on this rank, parallel/mesh.py) both
run on this rank's rows: the coarse rows it owns are those whose fine row
c·(ci+1)−1 it owns (`RowSlab.coarse_rows`), so the row axis starts at that
fine row instead of c−1, and the stencil's reach comes from the halo.

A field with members, (B, *grid), is restricted and prolonged on its
trailing grid axes, member by member alike (ops/stencil_ops.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from evostencils_torch.ops import stencil_kernel
from evostencils_torch.ops.stencil_ops import member_shape, pad, plain_constant_stencil, scalar
from evostencils_torch.stencils import constant


def restrict(
    fine: torch.Tensor,
    stencil: constant.Stencil,
    coarse_shape: Tuple[int, ...],
    coarsening: Tuple[int, ...],
    slab=None,
) -> torch.Tensor:
    """coarse[ci] = Σ_o w_o · fine[c·(ci+1)-1 + o] (zero outside interior);
    on a fine slab, this rank's coarse rows.  One launch of the stencil
    kernel where its gate takes the call (ops/stencil_kernel.py)."""
    fine_shape = fine.shape[fine.dim() - len(coarse_shape):]
    if stencil_kernel.check(fine, stencil, slab, fine_shape, coarse_shape, coarsening):
        return stencil_kernel.restrict(fine, stencil, coarse_shape, coarsening)
    reach = stencil.max_reach()
    padded = pad(fine, reach, slab)
    first = [c - 1 for c in coarsening]
    coarse_shape = list(coarse_shape)
    if slab is not None:
        clo, chi = slab.coarse_rows(coarsening[0])
        first[0] = coarsening[0] * (clo + 1) - 1 - slab.lo
        coarse_shape[0] = chi - clo
    out = None
    for offset, value in stencil.entries:
        index = tuple(
            slice(s + o + r, s + o + r + c * (m - 1) + 1, c)
            for s, c, o, r, m in zip(first, coarsening, offset, reach, coarse_shape)
        )
        term = scalar(value) * padded[(Ellipsis,) + index]
        out = term if out is None else out + term
    if out is None:
        return torch.zeros(member_shape(fine, len(coarse_shape)) + tuple(coarse_shape),
                           dtype=fine.dtype, device=fine.device)
    return out


def inject_to_fine(
    coarse: torch.Tensor, fine_shape: Tuple[int, ...], coarsening: Tuple[int, ...], slab=None
) -> torch.Tensor:
    """A zero fine field holding the coarse values at their fine nodes; on
    a fine slab (`fine_shape` its local shape) `coarse` holds this rank's
    coarse rows."""
    first = [c - 1 for c in coarsening]
    if slab is not None:
        first[0] = coarsening[0] * (slab.coarse_rows(coarsening[0])[0] + 1) - 1 - slab.lo
    fine = torch.zeros(member_shape(coarse, len(fine_shape)) + tuple(fine_shape),
                       dtype=coarse.dtype, device=coarse.device)
    fine[(Ellipsis,) + tuple(slice(s, None, c) for s, c in zip(first, coarsening))] = coarse
    return fine


def prolong(
    coarse: torch.Tensor,
    stencil: constant.Stencil,
    fine_shape: Tuple[int, ...],
    coarsening: Tuple[int, ...],
    slab=None,
) -> torch.Tensor:
    """fine = stencil ∘ injection(coarse); multilinear weights interpolate.
    On a fine slab, `coarse` is this rank's coarse rows and `fine_shape` the
    slab's shape.  One launch of the stencil kernel, injection included,
    where its gate takes the call (ops/stencil_kernel.py)."""
    coarse_shape = coarse.shape[coarse.dim() - len(fine_shape):]
    if stencil_kernel.check(coarse, stencil, slab, fine_shape, coarse_shape, coarsening):
        return stencil_kernel.prolong(coarse, stencil, fine_shape, coarsening)
    return plain_constant_stencil(
        inject_to_fine(coarse, fine_shape, coarsening, slab), stencil, slab)
