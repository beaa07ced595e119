"""The red-black sweep: its plain torch version against the Pallas kernels
run in interpret mode on the CPU (as tests/test_pallas.py runs them), the
wrapper's device rule and the gate.  The CUDA kernel itself is held against
the plain version in tests/test_torch_cuda.py, which needs a card.

Inputs are made from a seed with numpy.  Tolerance atol 5e-5, as
tests/test_pallas.py holds the Pallas kernels: two float32 half-sweeps
whose stencil sums round in another order.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.ops.pallas_kernels import _rb_blocked_call, _rb_sweep_call
from evostencils_torch.ir.base import Grid
from evostencils_torch.ops import rb_sweep
from evostencils_torch.stencils import constant, gallery

ENTRIES = {
    "5-point": (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0)),
    # Same-colour diagonal coupling: catches an update in place within a colour.
    "9-point": (((0, 0), 8.0 / 3), ((1, 0), -1 / 3), ((-1, 0), -1 / 3), ((0, 1), -1 / 3),
                ((0, -1), -1 / 3), ((1, 1), -1 / 3), ((1, -1), -1 / 3), ((-1, 1), -1 / 3),
                ((-1, -1), -1 / 3)),
    # No symmetry, radius 4 (the row-blocked kernel's limit): a sign or axis
    # error in the offsets shows up here.
    "asymmetric": (((0, 0), 4.0), ((1, 0), -1.5), ((-1, 0), -0.5), ((0, 1), -0.75),
                   ((0, -2), -0.25), ((2, -1), 0.125), ((-4, 3), -0.0625), ((3, 4), 0.1)),
}
OMEGA = 1.15


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(ENTRIES))
@pytest.mark.parametrize(
    "shape, pallas_call",
    [((15, 15), _rb_sweep_call), ((161, 96), _rb_blocked_call)],
    ids=["whole-array-15x15", "row-blocked-161x96"],
)
def test_plain_version_matches_pallas_interpret(name, shape, pallas_call):
    entries = ENTRIES[name]
    stencil = constant.Stencil(entries)
    u, f = _inputs(shape, 3)
    inv_diag = 1.0 / entries[0][1]
    expected = pallas_call(
        jnp.asarray(u, dtype=jnp.float32), jnp.asarray(f, dtype=jnp.float32),
        jnp.asarray([OMEGA], dtype=jnp.float32), entries, inv_diag, True,
    )
    got = rb_sweep.rb_sweep_reference(torch.from_numpy(u), torch.from_numpy(f), OMEGA, stencil)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=5e-5)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    stencil = constant.Stencil(ENTRIES["9-point"])
    u, f = (torch.from_numpy(x) for x in _inputs((33, 20), 4))
    before = rb_sweep.launches.total()
    out = rb_sweep.red_black_collective_jacobi_sweep(u, f, OMEGA, stencil)
    assert rb_sweep.launches.total() == before
    torch.testing.assert_close(out, rb_sweep.rb_sweep_reference(u, f, OMEGA, stencil), rtol=0, atol=0)
    # A one-element ω tensor is the same ω.
    out_t = rb_sweep.red_black_collective_jacobi_sweep(
        u, f, torch.tensor([OMEGA], dtype=torch.float32), stencil)
    torch.testing.assert_close(out_t, out, rtol=0, atol=0)
    with pytest.raises(ValueError):
        rb_sweep.red_black_collective_jacobi_sweep(u.to("meta"), f.to("meta"), OMEGA, stencil)


def test_gate():
    stencil = gallery.Poisson2D().generate_stencil(Grid((16, 16), (1 / 16, 1 / 16), 4))
    assert rb_sweep.supports_rb_sweep((15, 15), stencil, torch.float32)
    assert rb_sweep.supports_rb_sweep((1023, 1023), stencil, torch.float32)
    assert not rb_sweep.supports_rb_sweep((15, 15), stencil, torch.float64)
    assert not rb_sweep.supports_rb_sweep((15, 15, 15), stencil, torch.float32)
    wide = constant.Stencil([((0, 0), 2.0), ((5, 0), -1.0)])
    assert not rb_sweep.supports_rb_sweep((15, 15), wide, torch.float32)
    four = constant.Stencil([((0, 0), 2.0), ((4, -4), -1.0)])
    assert rb_sweep.supports_rb_sweep((15, 15), four, torch.float32)
    helm = gallery.Helmholtz2D(10.0, complex(1, 0.5)).generate_stencil(
        Grid((16, 16), (1 / 16, 1 / 16), 4))
    assert not rb_sweep.supports_rb_sweep((15, 15), helm, torch.float32)


def test_template_radius_and_block_shape():
    # The smallest instantiated halo (R in 1, 2, 4) that covers the stencil.
    for offset, expected in [((1, 0), 1), ((1, -1), 1), ((0, 2), 2), ((-2, 1), 2),
                             ((3, 0), 4), ((0, -3), 4), ((4, -4), 4)]:
        stencil = constant.Stencil([((0, 0), 2.0), (offset, -1.0)])
        assert rb_sweep.template_radius(rb_sweep._stencil_radius(stencil.entries)) == expected
        radius, dense, present, inv_diag = rb_sweep._kernel_stencil(stencil)
        assert radius == expected and inv_diag == 0.5
        # The dense 9 x 9 coefficient grid and its presence bits, as the
        # kernel's C entry point reads them.
        k = (offset[0] + 4) * 9 + (offset[1] + 4)
        assert dense[k] == -1.0 and dense[40] == 2.0
        assert [(present[i // 32] >> (i % 32)) & 1 for i in range(81)].count(1) == 2
        assert (present[k // 32] >> (k % 32)) & 1 and (present[1] >> 8) & 1
    for stencil in (constant.Stencil(ENTRIES[name]) for name in ENTRIES):
        assert rb_sweep.supports_rb_sweep((15, 15), stencil, torch.float32)
    assert rb_sweep._kernel_stencil(constant.Stencil(ENTRIES["5-point"]))[0] == 1
    assert rb_sweep._kernel_stencil(constant.Stencil(ENTRIES["9-point"]))[0] == 1
    assert rb_sweep._kernel_stencil(constant.Stencil(ENTRIES["asymmetric"]))[0] == 4
    # Radius 5 is beyond the kernel: the gate refuses it and no instance covers it.
    wide = constant.Stencil([((0, 0), 2.0), ((0, -5), -1.0)])
    assert not rb_sweep.supports_rb_sweep((15, 15), wide, torch.float32)
    with pytest.raises(ValueError):
        rb_sweep.template_radius(5)
    # The C entry point picks one of two instantiated block shapes from the
    # grid size, split at 256² cells: the levels up to 255² take one, 511²
    # and 1023² the other (tests/test_torch_cuda.py runs both on a card).
    source = (pathlib.Path(rb_sweep.__file__).parent.parent / "csrc" / "rb_sweep.cu").read_text()
    shapes = re.findall(r"return launch<R, P, (\d+), (\d+)>", source)
    assert sorted((int(a), int(b)) for a, b in shapes) == [(8, 8), (12, 4)]
    assert "static_cast<long long>(rows) * cols <= 256 * 256" in source


def test_bound_of_a_sweep_is_twelve_bytes_a_point_over_the_memory_rate():
    from evostencils_torch import measure

    # Read u and f, write the result: 12 bytes a point over 3.35 TB/s.
    assert measure.bound_ms((511, 511)) == pytest.approx(12 * 511 * 511 / 3.35e9, rel=1e-12)
    assert measure.bound_ms((1023, 1023)) == pytest.approx(3.7487606e-3, rel=1e-6)
    assert measure.LEVELS == [(2**k - 1, 2**k - 1) for k in range(6, 11)]


def test_float_omega_reuses_one_device_tensor():
    # A float ω becomes one cached one-element tensor per (value, device),
    # so the main path launches no fill kernel per sweep.
    first = rb_sweep._device_omega(1.15, torch.device("cpu"))
    assert first.shape == (1,) and first.dtype == torch.float32
    assert rb_sweep._device_omega(1.15, torch.device("cpu")) is first
    assert rb_sweep._device_omega(0.8, torch.device("cpu")) is not first
    assert float(first) == pytest.approx(1.15)
    # A tensor ω is used as it is given.
    given = torch.tensor([0.9], dtype=torch.float32)
    assert rb_sweep._device_omega(given, torch.device("cpu")).data_ptr() == given.data_ptr()


def test_lowering_takes_the_sweep_for_float32_red_black_jacobi():
    from evostencils_torch.grammar.multigrid import generate_primitive_set
    from evostencils_torch.ir import smoother
    from evostencils_torch.backend.lowering import CycleLowering
    from evostencils_torch.problems.poisson import poisson_2d

    problem = poisson_2d(3, 4, dtype=torch.float32)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=1, maximum_local_system_size=4,
    )
    A = terminals[0].operator
    B = smoother.generate_collective_jacobi(A)
    stencil = A.entries[0][0].generate_stencil()
    u, f = _inputs((15, 15), 5)
    u32, f32 = torch.from_numpy(u), torch.from_numpy(f)
    fused = CycleLowering(torch.float32, "cpu")._apply_smoothing((u32,), (f32,), B, A, "rb", OMEGA)
    torch.testing.assert_close(
        fused[0], rb_sweep.rb_sweep_reference(u32, f32, OMEGA, stencil), rtol=0, atol=0)
    # float64 is outside the gate and takes the masked two-sweep path.
    masked = CycleLowering(torch.float64, "cpu")._apply_smoothing(
        (u32.double(),), (f32.double(),), B, A, "rb", OMEGA)
    scale = float(masked[0].abs().max())
    np.testing.assert_allclose(fused[0].numpy() / scale, masked[0].numpy() / scale, atol=1e-6)
