"""Carry the reference's arrays across to the port.

For this system the reference's "weights" are the evaluation state
`(u, f)` as numpy, a cycle-VM `Program` (opcodes, ω, length), the numpy
matrices a `DenseSolveSpec.inv` or `BlockSolveSpec.inv_l` holds, and the
coefficient planes of a variable-coefficient stencil generator.
These functions turn them into the port's tensors and specs on a given
device and dtype, so a test can feed the JAX package's own data to both
sides.  They read plain numpy attributes and import nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from evostencils_torch import numpy_dtype
from evostencils_torch.backend.vm import Program
from evostencils_torch.ops.coarse_solve import DenseSolveSpec
from evostencils_torch.ops.smoothers import BlockSolveSpec


def state_to_torch(state, device, dtype):
    """A tuple of numpy fields (or anything np.asarray takes) as tensors."""
    np_dtype = numpy_dtype(dtype)
    return tuple(
        torch.from_numpy(np.array(x, dtype=np_dtype)).to(device) for x in state
    )


def planes_to_torch(offsets_and_planes, device, dtype):
    """(offsets, planes) of a generator's `generate_coefficient_arrays`, as
    numpy, with the planes cast to `dtype` on `device` (the cast the
    lowering makes), so both packages apply the same coefficients."""
    offsets, planes = offsets_and_planes
    np_dtype = numpy_dtype(dtype)
    return (
        tuple(tuple(int(o) for o in offset) for offset in offsets),
        [torch.from_numpy(np.array(p, dtype=np_dtype)).to(device) for p in planes],
    )


def program_from_reference(program) -> Program:
    """The port's VM Program for a reference VM Program: the padding the
    reference needs for its compiled interpreter is cut off, ω stays
    float32.  Opcode numbers carry over because both VMs register the same
    branches in the same order."""
    length = int(program.length)
    return Program(
        np.asarray(program.opcodes, dtype=np.int32)[:length].copy(),
        np.asarray(program.omegas, dtype=np.float32)[:length].copy(),
        length,
    )


def dense_solve_spec_from_reference(spec, device, dtype) -> DenseSolveSpec:
    """The port's dense coarse solve holding the reference spec's inverse."""
    return DenseSolveSpec(np.asarray(spec.inv), spec.field_shapes, dtype, device)


def block_solve_spec_from_reference(spec, device, dtype) -> BlockSolveSpec:
    """The port's block-Jacobi solve holding the reference spec's L^{-1}."""
    return BlockSolveSpec(spec.period, spec.n_fields, np.asarray(spec.inv_l), dtype, device)
