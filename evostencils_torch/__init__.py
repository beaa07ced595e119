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

    problems/   jax-free Problem and every family of the reference's
                registry: 1D/2D/3D Poisson, variable-coefficient Poisson
                (2D, 3D), linear elasticity (two fields), 2D Helmholtz with
                its complex shifted-Laplacian preconditioner (Dirichlet or
                Robin) and the nonlinear FAS problem; parser.py loads
                ExaSlang-style .exa2/.exa3/.exa4 specs (load_problem_file)
    ops/        stencils (constant and variable), transfers, coarse solve,
                smoothers, the Krylov
                solvers (CG, CR, MinRes, BiCGStab, preconditioned
                BiCGStab) and the hand-written CUDA red-black sweep
                (csrc/rb_sweep.cu)
    backend/    IR -> eager torch cycle (linear, variable-coefficient and
                nonlinear FAS operators), cycle VM, fitness evaluation
                (single and same-structure groups, FAS, the outer-Krylov
                solve and the k-ladder of Helmholtz), and graphs.py: the
                measurement loops' bodies captured once in CUDA graphs and
                replayed (the counterpart of the reference's jit)
    optimization/optimizer.py, relaxation.py: the evolutionary optimizer
                and the ω tuners (torch.autograd, CMA-ES)
    parallel/   population dispatch: a thread pool, or a torch.distributed
                process group splitting each generation's evaluations; the
                (dp, sp) device mesh: grids split by rows, halo exchanges
    interop.py  carries the reference's arrays, coefficient planes, VM
                programs and solve specs across to torch

The entry scripts are scripts/torch_*.py (torch_optimize.py evolves;
the others evaluate, tune, time and calibrate) and docs/torch_tutorial.py.
Every entry point runs on
the card (`device="cuda"`) unless the caller asks for the CPU, and takes
torch.float32, float64, complex64 or complex128 (the complex dtypes for
Helmholtz; the CUDA kernel is float32 only, as the reference's).  TF32 is switched off at import: the
reference pins full-f32 precision on its transfers for the same reason
(evostencils_tpu/ops/intergrid.py:118-132).
"""

import numpy as np
import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_NUMPY_DTYPES = {
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.complex64: np.dtype(np.complex64),
    torch.complex128: np.dtype(np.complex128),
}


class NotPortedError(Exception):
    """An IR feature the reference supports but this port does not yet.

    Deliberately not a RuntimeError, ValueError or NotImplementedError:
    fitness evaluation maps those to an infinite (bad) fitness, and an
    unported feature must fail loudly instead of looking like a bad
    individual."""


class CudaKernelError(Exception):
    """A hand-written CUDA kernel failed to build or to launch.  Not a
    RuntimeError, for the same reason as NotPortedError."""


class CudaGraphError(Exception):
    """A measurement loop could not be captured in a CUDA graph
    (backend/graphs.py): its body reads a value to the host or copies one
    to the device.  Not a RuntimeError, for the same reason as
    NotPortedError: an individual timed eagerly beside graph replays would
    carry a time of another kind, so it is never scored that way."""


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy floating or complex dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NUMPY_DTYPES:
            raise NotPortedError(f"dtype {dtype}: not one of {sorted(map(str, _NUMPY_DTYPES))}")
        return _NUMPY_DTYPES[dtype]
    np_dtype = np.dtype(dtype)
    if np_dtype not in _NUMPY_DTYPES.values():
        raise NotPortedError(f"dtype {np_dtype}: not one of {sorted(map(str, _NUMPY_DTYPES))}")
    return np_dtype


def dtype_is_complex(dtype) -> bool:
    return numpy_dtype(dtype).kind == "c"


def dtype_is_64bit(dtype) -> bool:
    """True for float64 and complex128."""
    return numpy_dtype(dtype) in (np.dtype(np.float64), np.dtype(np.complex128))
