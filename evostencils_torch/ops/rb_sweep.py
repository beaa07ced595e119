"""Fused red-black collective-Jacobi sweep: the CUDA kernel's wrapper, its
gate and its plain torch version.

The kernel (csrc/rb_sweep.cu) replaces both Pallas kernels of
evostencils_tpu/ops/pallas_kernels.py: one step of red-black point Jacobi
for a scalar 2D real constant stencil, both colours in one launch.  The
wrapper takes the plain version for tensors on the CPU only; for CUDA
tensors it launches the kernel or raises.

A state with members, `(B, rows, cols)` with one ω per member, is one
batched launch (the reference's group path vmaps its Pallas calls, which
prepends a batch axis to their grids): member b is the single launch's
step on u[b], f[b] with ω[b], bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

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
# Most members of one batched launch: the reference's largest group bucket.
MAX_MEMBERS = 16
# Side of the dense coefficient grid the kernel's C entry point reads.
_SIDE = 2 * MAX_RADIUS + 1

# The C entry points: u, f, out and ω on the device, the stencil's dense
# coefficients and presence bits on the host, its template radius and
# 1/centre, the shape (the batched launch takes the member count first)
# and the stream.
_STENCIL_ARGS = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
                 ctypes.c_int, ctypes.c_float]
_build.entry("rb_sweep_f32", [ctypes.c_void_p] * 4 + _STENCIL_ARGS + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
_build.entry("rb_sweep_f32_batched", [ctypes.c_void_p] * 4 + _STENCIL_ARGS
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])

# Kernel launches that reached the device, by grid shape (rows, cols), or
# (members, rows, cols) for a batched launch, since the last clear_counts(),
# eager or replayed (ops/_build.py counts them).
launches = _build.counter()
# The part of `launches` that graph replays ran.
replayed = _build.replayed(launches)


def count_launch(shape) -> None:
    _build.count(launches, tuple(shape))


def clear_counts() -> None:
    _build.clear(launches)


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
    kernel rounds it.  A float ω becomes a filled tensor, never one made
    from host data, so the plain cycle, too, can be captured.  With members
    (u, f of shape (B, rows, cols)) ω is a tensor of B values, or one float
    for all."""
    scale = (u.shape[0], 1, 1) if u.dim() == 3 else ()
    if torch.is_tensor(omega):
        w = omega.to(dtype=u.dtype, device=u.device).reshape(scale)
    else:
        w = torch.full(scale, float(omega), dtype=u.dtype, device=u.device)
    w = w * float(1.0 / stencil.center_value())
    # red = (row + col) even, on interior indices starting at 0.
    for mask in red_black_masks(tuple(u.shape[-2:]), torch.bool, u.device):
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


def _device_omega(omega, device, members: int = 1) -> torch.Tensor:
    """ω as a float32 tensor of `members` contiguous values on `device`: a
    tensor ω as its view (a copy where it is strided), which a CUDA graph
    reads anew at every replay; a float ω for one member reuses one cached
    tensor per (value, device), so it launches no fill kernel per sweep.
    Under a capture a float ω gets a tensor of the graph's own: a cached one
    filled there would live in the graph's pool and hold its value only once
    the graph has replayed."""
    if torch.is_tensor(omega):
        return omega.to(device=device, dtype=torch.float32).reshape(members).contiguous()
    if members > 1 or (torch.device(device).type == "cuda"
                       and torch.cuda.is_current_stream_capturing()):
        return torch.full((members,), float(omega), dtype=torch.float32, device=device)
    return _cached_omega(float(omega), str(device))


def red_black_collective_jacobi_sweep(u, f, omega, stencil: constant.Stencil) -> torch.Tensor:
    """One red-black point-Jacobi step, both colours: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  `omega` is a float
    or a one-element float32 tensor on u's device.  u and f of shape (B,
    rows, cols), 1 ≤ B ≤ MAX_MEMBERS, take one batched launch, with ω a
    tensor of B values (one per member) or a float."""
    if u.device.type == "cpu":
        return rb_sweep_reference(u, f, omega, stencil)
    if u.device.type != "cuda":
        raise ValueError(f"red-black sweep: no kernel for device {u.device}")
    batched = u.dim() == 3
    if batched and not 1 <= u.shape[0] <= MAX_MEMBERS:
        raise ValueError(f"red-black sweep: {u.shape[0]} members, at most {MAX_MEMBERS}")
    if not supports_rb_sweep(tuple(u.shape[-2:]), stencil, u.dtype) or u.dim() not in (2, 3):
        raise ValueError(f"red-black sweep: unsupported {u.dtype} {tuple(u.shape)} {stencil!r}")
    if f.shape != u.shape or f.dtype != u.dtype or f.device != u.device:
        raise ValueError("red-black sweep: u and f differ in shape, dtype or device")
    u = u.contiguous()
    f = f.contiguous()
    omega_arg = _device_omega(omega, u.device, u.shape[0] if batched else 1)
    radius, dense, present, inv_diag = _kernel_stencil(stencil)
    out = torch.empty_like(u)
    lib = _build.library()
    pointers = (u.data_ptr(), f.data_ptr(), out.data_ptr(), omega_arg.data_ptr(),
                dense, present, radius, inv_diag)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    if batched:
        name = "rb_sweep_f32_batched"
        err = lib.rb_sweep_f32_batched(*pointers, *u.shape, stream)
    else:
        name = "rb_sweep_f32"
        err = lib.rb_sweep_f32(*pointers, *u.shape, stream)
    if err != 0:
        raise CudaKernelError(f"{name} did not launch: CUDA error {err}")
    _build.count(launches, tuple(u.shape), u)
    return out
