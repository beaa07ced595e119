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

import torch

from evostencils_tpu.stencils import constant
from evostencils_torch import CudaKernelError
from evostencils_torch.ops import _build
from evostencils_torch.ops.stencil_ops import apply_constant_stencil, red_black_masks

# Largest stencil radius the kernel's shared-memory halo covers
# (MAX_RADIUS in csrc/rb_sweep.cu); the TPU's row-blocked kernel had the
# same limit.
MAX_RADIUS = 4

# Kernel launches by grid shape (rows, cols) since the last clear():
# counted where the kernel launches, nowhere else.
launches = collections.Counter()

_device_stencils = {}


def _stencil_radius(entries) -> int:
    return max((max(abs(o) for o in off) for off, _ in entries), default=0)


def supports_rb_sweep(shape, stencil, dtype) -> bool:
    """The gate: 2D, float32, a real constant stencil within the halo."""
    return (
        len(shape) == 2
        and isinstance(stencil, constant.Stencil)
        and stencil.dimension == 2
        and dtype == torch.float32
        and all(not isinstance(v, complex) for v in stencil.values)
        and _stencil_radius(stencil.entries) <= MAX_RADIUS
    )


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


def _device_stencil(stencil: constant.Stencil, device):
    key = (stencil.entries, str(device))
    tensors = _device_stencils.get(key)
    if tensors is None:
        offsets = torch.tensor(
            [o for offset, _ in stencil.entries for o in offset], dtype=torch.int32
        ).to(device)
        values = torch.tensor(
            [float(v) for _, v in stencil.entries], dtype=torch.float32
        ).to(device)
        tensors = (offsets, values)
        _device_stencils[key] = tensors
    return tensors


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
    if torch.is_tensor(omega):
        omega_arg = omega.to(device=u.device, dtype=torch.float32).reshape(1)
    else:
        omega_arg = torch.full((1,), float(omega), dtype=torch.float32, device=u.device)
    offsets, values = _device_stencil(stencil, u.device)
    out = torch.empty_like(u)
    lib = _build.library()
    err = lib.rb_sweep_f32(
        u.data_ptr(), f.data_ptr(), out.data_ptr(), omega_arg.data_ptr(),
        offsets.data_ptr(), values.data_ptr(), stencil.number_of_entries,
        float(1.0 / stencil.center_value()), u.shape[0], u.shape[1],
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    if err != 0:
        raise CudaKernelError(f"rb_sweep_f32 did not launch: CUDA error {err}")
    launches[tuple(u.shape)] += 1
    return out
