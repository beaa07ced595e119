"""Restriction and prolongation (counterpart of evostencils_tpu/ops/intergrid.py).

Vertex-centred hierarchy with Dirichlet boundaries, as in the reference:
  * the fine grid of level l has interior nodes 1..2^l-1 per axis,
  * coarse node `ci` (local) coincides with fine local node `c*(ci+1)-1`
    for coarsening factor c (c=2: the odd fine indices).

Restriction is the stencil on the fine grid read at the coarse lattice,
computed as strided views of the zero-padded fine field; prolongation
injects the coarse values into a zero fine field and applies the stencil.
The reference's per-axis factor matrices and conv tiers are TPU layout
choices and have no counterpart here.

With a `slab` (the fine grid's rows on this rank, parallel/mesh.py) both
run on this rank's rows: the coarse rows it owns are those whose fine row
c·(ci+1)−1 it owns (`RowSlab.coarse_rows`), so the row axis starts at that
fine row instead of c−1, and the stencil's reach comes from the halo.
"""

from __future__ import annotations

from typing import Tuple

import torch

from evostencils_torch.ops.stencil_ops import apply_constant_stencil, pad, scalar
from evostencils_torch.stencils import constant


def restrict(
    fine: torch.Tensor,
    stencil: constant.Stencil,
    coarse_shape: Tuple[int, ...],
    coarsening: Tuple[int, ...],
    slab=None,
) -> torch.Tensor:
    """coarse[ci] = Σ_o w_o · fine[c·(ci+1)-1 + o] (zero outside interior);
    on a fine slab, this rank's coarse rows."""
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
        term = scalar(value) * padded[index]
        out = term if out is None else out + term
    if out is None:
        return torch.zeros(coarse_shape, dtype=fine.dtype, device=fine.device)
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
    fine = torch.zeros(fine_shape, dtype=coarse.dtype, device=coarse.device)
    fine[tuple(slice(s, None, c) for s, c in zip(first, coarsening))] = coarse
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
    slab's shape."""
    return apply_constant_stencil(
        inject_to_fine(coarse, fine_shape, coarsening, slab), stencil, slab)
