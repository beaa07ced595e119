"""evostencils_torch — the fitness evaluation and the evolutionary search
of evostencils_tpu on PyTorch and CUDA.

The JAX package `evostencils_tpu` stays the reference.  This package
imports nothing of it: it keeps its own copies of the reference's
array-free layers, which differ from them only in their import paths, so
a grammar tree string compiles to the same IR on both sides:

    stencils/   constant and periodic stencil algebra, stencil gallery
    ir/         the multigrid expression IR, reference cycles, canonical strings
    grammar/    the typed G3P grammar (gp, multigrid, typing)
    utils/      champions.py: the stored champions' file format;
                logbook.py: statistics, logbooks, halls of fame
    optimization/selection.py, intergrid_transfer.py: NSGA-II/III and
                tournament selection; CMA-ES

and owns every layer that touches arrays:

    problems/   jax-free Problem and the 2D Poisson family
    ops/        stencils, transfers, coarse solve, smoothers, and the
                hand-written CUDA red-black sweep (csrc/rb_sweep.cu)
    backend/    IR -> eager torch cycle, cycle VM, fitness evaluation
                (single and same-structure groups)
    optimization/optimizer.py, relaxation.py: the evolutionary optimizer
                and the ω tuners (torch.autograd, CMA-ES)
    interop.py  carries the reference's arrays, VM programs and solve
                specs across to torch

The entry script is scripts/torch_optimize.py.  Every entry point runs on
the card (`device="cuda"`) unless the caller asks for the CPU, and takes
torch.float32 or torch.float64.  TF32 is switched off at import: the
reference pins full-f32 precision on its transfers for the same reason
(evostencils_tpu/ops/intergrid.py:118-132).
"""

import numpy as np
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_NUMPY_DTYPES = {torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64)}


class NotPortedError(Exception):
    """An IR feature the reference supports but this port does not yet.

    Deliberately not a RuntimeError, ValueError or NotImplementedError:
    fitness evaluation maps those to an infinite (bad) fitness, and an
    unported feature must fail loudly instead of looking like a bad
    individual."""


class CudaKernelError(Exception):
    """A hand-written CUDA kernel failed to build or to launch.  Not a
    RuntimeError, for the same reason as NotPortedError."""


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy real floating dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NUMPY_DTYPES:
            raise NotPortedError(f"dtype {dtype}: only float32 and float64 are ported")
        return _NUMPY_DTYPES[dtype]
    np_dtype = np.dtype(dtype)
    if np_dtype not in _NUMPY_DTYPES.values():
        raise NotPortedError(f"dtype {np_dtype}: only float32 and float64 are ported")
    return np_dtype

