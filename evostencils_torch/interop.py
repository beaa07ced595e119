"""Carry the reference's arrays across to the port.

For this system the reference's "weights" are the evaluation state
`(u, f)` as numpy, a cycle-VM `Program` (opcodes, ω, length), the numpy
matrices a `DenseSolveSpec.inv` or `BlockSolveSpec.inv_l` holds, the
coefficient planes of a variable-coefficient stencil generator, and the
constants of a roofline model.
These functions turn them into the port's tensors and specs on a given
device and dtype, so a test can feed the JAX package's own data to both
sides, and (`state_to_slabs`, `state_from_slabs`) cut a whole state into
this rank's rows of a device mesh and put it back together.  They read
plain numpy attributes and import nothing of JAX.
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


def state_to_slabs(state, layout, device, dtype):
    """This rank's rows (parallel/mesh.py `MeshLayout`) of each whole field
    of a numpy state, as tensors; a field of a replicated grid stays
    whole."""
    np_dtype = numpy_dtype(dtype)
    out = []
    for x in state:
        x = np.asarray(x, dtype=np_dtype)
        slab = layout.slab(x.shape)
        out.append(torch.from_numpy(np.ascontiguousarray(x if slab is None else slab.cut(x))).to(
            device))
    return tuple(out)


def state_from_slabs(state, global_shapes, layout):
    """The whole numpy fields of a state held in slabs, on every rank."""
    from evostencils_torch.parallel.mesh import gather_state

    return tuple(x.cpu().numpy() for x in gather_state(state, global_shapes, layout))


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


def performance_evaluator_from_reference(evaluator):
    """The port's roofline model holding a reference evaluator's constants
    (peak, bandwidth and the fitted factors), so both walk with the same
    numbers."""
    from evostencils_torch.models.roofline import PerformanceEvaluator

    return PerformanceEvaluator(
        peak_performance=evaluator.peak_performance,
        peak_bandwidth=evaluator.peak_bandwidth,
        bytes_per_word=evaluator.bytes_per_word,
        runtime_coarse_grid_solver=evaluator.runtime_coarse_grid_solver,
        red_black_penalty=evaluator.red_black_penalty,
        kernel_launch_overhead=evaluator.kernel_launch_overhead,
        red_black_traffic_factor=evaluator.red_black_traffic_factor,
        fusion_factor=evaluator.fusion_factor,
        single_sweep_fusion=evaluator.single_sweep_fusion,
        intergrid_factor=evaluator.intergrid_factor,
    )
