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
"""

from __future__ import annotations

from typing import Tuple

import torch

from evostencils_torch.ops.stencil_ops import apply_constant_stencil, pad_zeros, scalar
from evostencils_torch.stencils import constant


def restrict(
    fine: torch.Tensor,
    stencil: constant.Stencil,
    coarse_shape: Tuple[int, ...],
    coarsening: Tuple[int, ...],
) -> torch.Tensor:
    """coarse[ci] = Σ_o w_o · fine[c·(ci+1)-1 + o] (zero outside interior)."""
    reach = stencil.max_reach()
    padded = pad_zeros(fine, reach)
    out = None
    for offset, value in stencil.entries:
        index = tuple(
            slice(c - 1 + o + r, c - 1 + o + r + c * (m - 1) + 1, c)
            for c, o, r, m in zip(coarsening, offset, reach, coarse_shape)
        )
        term = scalar(value) * padded[index]
        out = term if out is None else out + term
    if out is None:
        return torch.zeros(coarse_shape, dtype=fine.dtype, device=fine.device)
    return out


def inject_to_fine(
    coarse: torch.Tensor, fine_shape: Tuple[int, ...], coarsening: Tuple[int, ...]
) -> torch.Tensor:
    fine = torch.zeros(fine_shape, dtype=coarse.dtype, device=coarse.device)
    fine[tuple(slice(c - 1, None, c) for c in coarsening)] = coarse
    return fine


def prolong(
    coarse: torch.Tensor,
    stencil: constant.Stencil,
    fine_shape: Tuple[int, ...],
    coarsening: Tuple[int, ...],
) -> torch.Tensor:
    """fine = stencil ∘ injection(coarse); multilinear weights interpolate."""
    return apply_constant_stencil(inject_to_fine(coarse, fine_shape, coarsening), stencil)
