"""A real constant 2D stencil in one CUDA launch: the wrapper of
csrc/stencil2d.cu, its gate and its counters.

`apply_constant_stencil` (ops/stencil_ops.py), `restrict` and `prolong`
(ops/intergrid.py) ask `refusal` first.  Where it returns None they call
`apply`, `restrict` or `prolong` here, one launch each; otherwise they run
their plain torch chains.  The kernel sums the stencil's entries in the
stencil's order with every product and sum rounded on its own, so its
output equals the chain's bit for bit (csrc/stencil2d.cu).

The gate takes a CUDA tensor of float32 or float64 holding a 2D grid,
without or with one leading member axis, outside a mesh (no `slab`), and a
`constant.Stencil` with real values, radius at most MAX_RADIUS and 1 to
MAX_ENTRIES entries; a transfer also needs the fine grid to be the coarse
one's refinement, n_fine = c·(n_coarse + 1) − 1 on each axis.  The kernel
has no backward, so a field that autograd records (the ω tuner's) is
refused too.  What it refuses is what the plain chain computes as before:
complex Helmholtz fields, 3D grids, mesh slabs, the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from evostencils_torch import CudaKernelError
from evostencils_torch.ops import _build
from evostencils_torch.stencils import constant

# The widest stencil and the most entries the kernel's parameters hold:
# every operator and transfer stencil of the 2D Poisson problems has at most
# 9 entries within radius 1.
MAX_RADIUS = 4
MAX_ENTRIES = 25
# Most members of one launch (gridDim.z).
MAX_MEMBERS = 65535
MODES = {"apply": 0, "restrict": 1, "prolong": 2}

# The C entry points, one a dtype: mode, in, out, the host arrays of offsets
# and weights, the count, members, both shapes, the coarsening factors and
# the stream.
for _name, _scalar in (("stencil2d_f32", ctypes.c_float), ("stencil2d_f64", ctypes.c_double)):
    _build.entry(_name, [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_scalar)]
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

# Launches that reached the device, by (mode, output shape), since the last
# clear_counts(), eager or replayed (ops/_build.py counts them).
launches = _build.counter()
# The gate's refusals by reason ("cpu", "slab", "dtype", "grad",
# "stencil", "dimension", "radius", "entries", "shape"), counted the same
# way: the calls that ran the plain chain.
plain = _build.counter()


def clear_counts() -> None:
    _build.clear(launches, plain)


@functools.lru_cache(maxsize=4096)
def _stencil_refusal(stencil: constant.Stencil) -> Optional[str]:
    if any(complex(v).imag != 0.0 for v in stencil.values):
        return "stencil"
    if stencil.dimension != 2:
        return "dimension"
    if max(stencil.max_reach()) > MAX_RADIUS:
        return "radius"
    if not 1 <= stencil.number_of_entries <= MAX_ENTRIES:
        return "entries"
    return None


def refusal(x: torch.Tensor, stencil, slab=None, fine_shape=None, coarse_shape=None,
            coarsening=None) -> Optional[str]:
    """None where the kernel takes the call, else why not.  `x` is the
    input field; a transfer gives its fine and coarse grid shapes and its
    coarsening factors."""
    if x.device.type != "cuda":
        return "cpu"
    if slab is not None:
        return "slab"
    if x.dtype not in (torch.float32, torch.float64):
        return "dtype"
    if x.requires_grad and torch.is_grad_enabled():
        return "grad"
    if not isinstance(stencil, constant.Stencil):
        return "stencil"
    reason = _stencil_refusal(stencil)
    if reason is not None:
        return reason
    if x.dim() not in (2, 3):
        return "dimension"
    if x.numel() == 0 or (x.dim() == 3 and x.shape[0] > MAX_MEMBERS):
        return "shape"
    if coarsening is not None and any(
            c < 1 or nf != c * (nc + 1) - 1
            for nf, nc, c in zip(fine_shape, coarse_shape, coarsening)):
        return "shape"
    return None


def check(x: torch.Tensor, stencil, slab=None, fine_shape=None, coarse_shape=None,
          coarsening=None) -> bool:
    """The gate's decision, each refusal counted under its reason."""
    reason = refusal(x, stencil, slab, fine_shape, coarse_shape, coarsening)
    if reason is None:
        return True
    _build.count(plain, reason, x, refusal=True)
    return False


@functools.lru_cache(maxsize=4096)
def packed(stencil: constant.Stencil, dtype: torch.dtype):
    """(count, offsets, weights) as the C entry point takes them: the
    entries in the stencil's order, (di, dj) pairs as ints and each weight
    as a C float or double, the rounding torch gives a Python scalar times
    a tensor of `dtype`."""
    scalar_type = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    n = stencil.number_of_entries
    offsets = (ctypes.c_int * (2 * n))(*(o for offset in stencil.offsets for o in offset))
    weights = (scalar_type * n)(*(complex(v).real for v in stencil.values))
    return n, offsets, weights


def _launch(mode: str, x: torch.Tensor, stencil: constant.Stencil,
            out_shape: Sequence[int], coarsening=(1, 1)) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty(tuple(x.shape[:-2]) + tuple(out_shape), dtype=x.dtype, device=x.device)
    n, offsets, weights = packed(stencil, x.dtype)
    lib = _build.library()
    entry = lib.stencil2d_f32 if x.dtype == torch.float32 else lib.stencil2d_f64
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = entry(MODES[mode], x.data_ptr(), out.data_ptr(), offsets, weights, n,
                x.shape[0] if x.dim() == 3 else 1, *x.shape[-2:], *out_shape, *coarsening,
                stream)
    if err != 0:
        raise CudaKernelError(f"stencil2d ({mode}) did not launch: CUDA error {err}")
    _build.count(launches, (mode, tuple(out.shape)), x)
    return out


def apply(u: torch.Tensor, stencil: constant.Stencil) -> torch.Tensor:
    """y[i, j] = Σ_o w_o · u[i + o₀, j + o₁], zero outside the grid."""
    return _launch("apply", u, stencil, u.shape[-2:])


def restrict(fine: torch.Tensor, stencil: constant.Stencil, coarse_shape,
             coarsening) -> torch.Tensor:
    """coarse[ci] = Σ_o w_o · fine[c·(ci + 1) − 1 + o], zero outside the grid."""
    return _launch("restrict", fine, stencil, tuple(coarse_shape), tuple(coarsening))


def prolong(coarse: torch.Tensor, stencil: constant.Stencil, fine_shape,
            coarsening) -> torch.Tensor:
    """The stencil applied to the zero fine field that holds the coarse
    values at their fine nodes."""
    return _launch("prolong", coarse, stencil, tuple(fine_shape), tuple(coarsening))
