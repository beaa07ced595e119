"""Fused red-black collective-Jacobi sweep: the CUDA kernel's wrapper, its
gate and its plain torch version.

The kernel (csrc/rb_sweep.cu) replaces both Pallas kernels of
evostencils_tpu/ops/pallas_kernels.py: one step of red-black point Jacobi
for a scalar 2D real constant stencil, both colours in one launch.  The
wrapper takes the plain version for tensors on the CPU only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from evostencils_torch import CudaKernelError
from evostencils_torch.ops import _build
from evostencils_torch.ops.stencil_ops import apply_constant_stencil, red_black_masks
from evostencils_torch.stencils import constant

# Largest stencil radius the kernel takes; the TPU's row-blocked kernel had
# the same limit.
MAX_RADIUS = 4
# The halo radii csrc/rb_sweep.cu is instantiated for.
TEMPLATE_RADII = (1, 2, 4)
# The reference's Pallas routes: whole-array up to 512² cells, row-blocked
# above, with blocks of 128 rows, up to 16384² cells.
WHOLE_ARRAY_CELLS = 512 * 512
BLOCK_ROWS = 128
MAX_BLOCKED_CELLS = 16384 * 16384
# Side of the dense coefficient grid the kernel's C entry point reads.
_SIDE = 2 * MAX_RADIUS + 1

# Kernel launches by grid shape (rows, cols) since the last clear():
# counted where the kernel launches, nowhere else (not where a CUDA graph
# capture records it, nor in the graph's replays).
launches = collections.Counter()
# Counter's += reads and then writes: threads that launch at once would
# lose counts without it.
_launches_lock = threading.Lock()


def count_launch(shape) -> None:
    with _launches_lock:
        launches[tuple(shape)] += 1


def _stencil_radius(entries) -> int:
    return max((max(abs(o) for o in off) for off, _ in entries), default=0)


def supports_rb_sweep(shape, stencil, dtype, slab=None) -> bool:
    """The gate: 2D, float32, a real constant stencil within the halo; above
    512² cells, as the reference's row-blocked route, more than 128 rows and
    at most 16384² cells (evostencils_tpu/ops/pallas_kernels.py:119-138).

    One difference of route, not of result: up to 512² cells the reference
    takes any radius, while this kernel is instantiated for radius ≤ 4 only,
    so a wider stencil takes the plain masked half-sweeps, which compute the
    same step.

    A `slab` (a state split by rows over a device mesh) is refused, as the
    reference turns its kernels off under a mesh
    (evostencils_tpu/backend/lowering.py:73-81): the kernel addresses the
    whole grid, and its black half-step reads red values of the same launch
    across the slab's edge."""
    if slab is not None:
        return False
    if not (
        len(shape) == 2
        and isinstance(stencil, constant.Stencil)
        and stencil.dimension == 2
        and dtype == torch.float32
        and all(not isinstance(v, complex) for v in stencil.values)
        and _stencil_radius(stencil.entries) <= MAX_RADIUS
    ):
        return False
    cells = shape[0] * shape[1]
    return cells <= WHOLE_ARRAY_CELLS or (cells <= MAX_BLOCKED_CELLS and shape[0] > BLOCK_ROWS)


def template_radius(radius: int) -> int:
    """The smallest radius the kernel is instantiated for that covers a
    stencil of this radius."""
    for candidate in TEMPLATE_RADII:
        if radius <= candidate:
            return candidate
    raise ValueError(f"red-black sweep: radius {radius} exceeds {MAX_RADIUS}")


def rb_sweep_reference(u, f, omega, stencil: constant.Stencil) -> torch.Tensor:
    """Plain torch version: two masked half-sweeps, the residual recomputed
    from the post-red values for black, w = ω·(1/centre) rounded as the
    kernel rounds it."""
    w = torch.as_tensor(omega, dtype=u.dtype, device=u.device).reshape(())
    w = w * float(1.0 / stencil.center_value())
    # red = (row + col) even, on interior indices starting at 0.
    for mask in red_black_masks(tuple(u.shape), torch.bool, u.device):
        r = f - apply_constant_stencil(u, stencil)
        u = u + torch.where(mask, w * r, 0.0)
    return u


@functools.lru_cache(maxsize=None)
def _kernel_stencil(stencil: constant.Stencil):
    """(template radius, dense coefficients, presence bits, 1/centre) as the
    C entry point takes them, built once per stencil."""
    dense = (ctypes.c_float * (_SIDE * _SIDE))()
    present = (ctypes.c_uint32 * 3)()
    for (di, dj), value in stencil.entries:
        k = (di + MAX_RADIUS) * _SIDE + (dj + MAX_RADIUS)
        dense[k] = float(value)
        present[k // 32] |= 1 << (k % 32)
    return (template_radius(_stencil_radius(stencil.entries)), dense, present,
            float(1.0 / stencil.center_value()))


@functools.lru_cache(maxsize=256)
def _cached_omega(value: float, device: str) -> torch.Tensor:
    return torch.full((1,), value, dtype=torch.float32, device=device)


def _device_omega(omega, device) -> torch.Tensor:
    """ω as a one-element float32 tensor on `device`; a float ω reuses one
    cached tensor per (value, device), so it launches no fill kernel per
    sweep."""
    if torch.is_tensor(omega):
        return omega.to(device=device, dtype=torch.float32).reshape(1)
    return _cached_omega(float(omega), str(device))


def red_black_collective_jacobi_sweep(u, f, omega, stencil: constant.Stencil) -> torch.Tensor:
    """One red-black point-Jacobi step, both colours: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  `omega` is a float
    or a one-element float32 tensor on u's device."""
    if u.device.type == "cpu":
        return rb_sweep_reference(u, f, omega, stencil)
    if u.device.type != "cuda":
        raise ValueError(f"red-black sweep: no kernel for device {u.device}")
    if not supports_rb_sweep(tuple(u.shape), stencil, u.dtype):
        raise ValueError(f"red-black sweep: unsupported {u.dtype} {tuple(u.shape)} {stencil!r}")
    if f.shape != u.shape or f.dtype != u.dtype or f.device != u.device:
        raise ValueError("red-black sweep: u and f differ in shape, dtype or device")
    u = u.contiguous()
    f = f.contiguous()
    omega_arg = _device_omega(omega, u.device)
    radius, dense, present, inv_diag = _kernel_stencil(stencil)
    out = torch.empty_like(u)
    lib = _build.library()
    err = lib.rb_sweep_f32(
        u.data_ptr(), f.data_ptr(), out.data_ptr(), omega_arg.data_ptr(),
        dense, present, radius, inv_diag, u.shape[0], u.shape[1],
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise CudaKernelError(f"rb_sweep_f32 did not launch: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        # A CUDA graph capture records the launch; its replays launch it.
        count_launch(u.shape)
    return out
