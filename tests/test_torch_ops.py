"""Parity of the torch ops (evostencils_torch/ops) with the JAX reference
(evostencils_tpu/ops) on the CPU, at 15² and 31².

Inputs are made from a seed with numpy and fed to both packages; each
package's ops get stencils built by that package's own stencil modules
(the port keeps its own copy of them).  Every
dtype is explicit: tests/conftest.py enables JAX's x64 mode, so JAX
inputs are built with `jnp.asarray(x, dtype=jnp.float32)`.  float32
tolerances: atol 1e-6 for a stencil sum of order-one values (a few ulp),
rel 1e-5 for the dense and block solves, whose summation order differs.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.ir import base
from evostencils_tpu.ops import coarse_solve as jcs
from evostencils_tpu.ops import intergrid as jig
from evostencils_tpu.ops import smoothers as jsm
from evostencils_tpu.ops import stencil_ops as jso
from evostencils_tpu.stencils import constant, gallery, periodic
from evostencils_torch import interop
from evostencils_torch.ir import base as port_base
from evostencils_torch.ops import coarse_solve, intergrid, smoothers, stencil_ops
from evostencils_torch.stencils import constant as port_constant
from evostencils_torch.stencils import gallery as port_gallery
from evostencils_torch.stencils import periodic as port_periodic

FINE = [(15, 15), (31, 31)]
REFERENCE = SimpleNamespace(base=base, constant=constant, gallery=gallery, periodic=periodic)
PORT = SimpleNamespace(
    base=port_base, constant=port_constant, gallery=port_gallery, periodic=port_periodic)


def _grid(n, side=REFERENCE):
    return side.base.Grid((n + 1, n + 1), (1.0 / (n + 1),) * 2, int(np.log2(n + 1)))


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32), torch.from_numpy(np.asarray(x, np.float32))


def _stencils(n, side):
    return {
        "poisson": side.gallery.Poisson2D().generate_stencil(_grid(n, side)),
        "nine_point": side.constant.Stencil(
            [((i, j), -1.0 if (i, j) != (0, 0) else 8.0) for i in (-1, 0, 1) for j in (-1, 0, 1)]
        ),
        "reach_two": side.constant.Stencil([((0, 0), 2.5), ((2, -1), -0.5), ((-2, 1), 0.75)]),
    }


@pytest.mark.parametrize("shape", FINE)
@pytest.mark.parametrize("name", ["poisson", "nine_point", "reach_two"])
def test_apply_constant_stencil_matches_reference(shape, name):
    stencil, port_stencil = (_stencils(shape[0], side)[name] for side in (REFERENCE, PORT))
    assert port_stencil.entries == stencil.entries
    x = np.random.default_rng(0).standard_normal(shape)
    xj, xt = _f32(x)
    expected = np.asarray(jso.apply_constant_stencil(xj, stencil))
    got = stencil_ops.apply_constant_stencil(xt, port_stencil)
    assert got.dtype == torch.float32
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(got.numpy() / scale, expected / scale, atol=1e-6)
    # The numpy oracle, in float64.
    np.testing.assert_allclose(
        stencil_ops.numpy_apply_constant_stencil(x, port_stencil),
        jso.numpy_apply_constant_stencil(x, stencil), rtol=1e-15, atol=1e-12,
    )


def test_periodic_stencil_and_masks_match_reference():
    shape = (15, 15)

    def periodic_stencil(side):
        cells = np.empty((2, 2), dtype=object)
        for index in np.ndindex(2, 2):
            cells[index] = side.constant.Stencil(
                [((0, 0), 4.0 + sum(index)), ((1, 0), -1.0 - index[0])])
        return side.periodic.PeriodicStencil(cells)

    stencil = periodic_stencil(REFERENCE)
    x = np.random.default_rng(1).standard_normal(shape)
    xj, xt = _f32(x)
    np.testing.assert_allclose(
        stencil_ops.apply_stencil(xt, periodic_stencil(PORT)).numpy(),
        np.asarray(jso.apply_stencil(xj, stencil)), atol=1e-6,
    )
    red_j, black_j = jso.red_black_masks(shape, dtype=jnp.float32)
    red_t, black_t = stencil_ops.red_black_masks(shape, torch.float32, "cpu")
    np.testing.assert_array_equal(red_t.numpy(), np.asarray(red_j))
    np.testing.assert_array_equal(black_t.numpy(), np.asarray(black_j))
    a, b = np.random.default_rng(2).standard_normal((2,) + shape)
    (aj, at), (bj, bt) = _f32(a), _f32(b)
    np.testing.assert_allclose(
        float(stencil_ops.dot((at,), (bt,))), float(jso.dot((aj,), (bj,))), rtol=1e-5)
    np.testing.assert_allclose(
        float(stencil_ops.l2_norm((at, bt))), float(jso.l2_norm((aj, bj))), rtol=1e-6)


@pytest.mark.parametrize("fine", FINE)
def test_restrict_and_prolong_match_reference(fine):
    coarse = ((fine[0] - 1) // 2,) * 2
    rng = np.random.default_rng(3)
    (fj, ft), (cj, ct) = _f32(rng.standard_normal(fine)), _f32(rng.standard_normal(coarse))
    skew = [((0, 0), 0.5), ((1, 1), 0.25), ((-1, 0), 0.125), ((0, -1), 0.125)]
    ref, port = ({
        "restriction": side.gallery.full_weighting_restriction_stencil(2),
        "prolongation": side.gallery.multilinear_interpolation_stencil(2),
        # A non-separable transfer takes the reference's conv tier.
        "skew": side.constant.Stencil(skew),
    } for side in (REFERENCE, PORT))
    for restriction, prolongation in (("restriction", "prolongation"), ("skew", "skew")):
        assert port[restriction].entries == ref[restriction].entries
        np.testing.assert_allclose(
            intergrid.restrict(ft, port[restriction], coarse, (2, 2)).numpy(),
            np.asarray(jig.restrict(fj, ref[restriction], coarse, (2, 2))), atol=1e-6,
        )
        np.testing.assert_allclose(
            intergrid.prolong(ct, port[prolongation], fine, (2, 2)).numpy(),
            np.asarray(jig.prolong(cj, ref[prolongation], fine, (2, 2))), atol=1e-6,
        )


def test_restrict_prolong_adjointness():
    # Full-weighting R = (1/2^d) P^T: <P uc, uf> == 2^d <uc, R uf>.
    rng = np.random.default_rng(0)
    fine_shape, coarse_shape = (15, 15), (7, 7)
    uf = torch.from_numpy(rng.standard_normal(fine_shape))
    uc = torch.from_numpy(rng.standard_normal(coarse_shape))
    Puc = intergrid.prolong(
        uc, port_gallery.multilinear_interpolation_stencil(2), fine_shape, (2, 2))
    Ruf = intergrid.restrict(
        uf, port_gallery.full_weighting_restriction_stencil(2), coarse_shape, (2, 2))
    assert abs(float(torch.sum(Puc * uf)) - 4.0 * float(torch.sum(uc * Ruf))) < 1e-9


def test_prolong_of_constant_interior():
    # Bilinear interpolation reproduces constants away from the boundary.
    uc = torch.ones((7, 7), dtype=torch.float64)
    out = intergrid.prolong(uc, port_gallery.multilinear_interpolation_stencil(2), (15, 15), (2, 2))
    np.testing.assert_allclose(out.numpy()[2:-2, 2:-2], 1.0, atol=1e-12)


def test_dense_solve_matches_reference_with_its_own_inverse():
    shape = (15, 15)
    stencil = gallery.Poisson2D().generate_stencil(_grid(15))
    port_stencil = port_gallery.Poisson2D().generate_stencil(_grid(15, PORT))
    np.testing.assert_array_equal(
        coarse_solve.assemble_scalar_matrix(port_stencil, shape),
        jcs.assemble_scalar_matrix(stencil, shape),
    )
    matrix = jcs.assemble_scalar_matrix(stencil, shape)
    spec_j = jcs.build_dense_solve_spec([[matrix]], [shape], jnp.float32)
    spec_t = interop.dense_solve_spec_from_reference(spec_j, "cpu", torch.float32)
    own = coarse_solve.build_dense_solve_spec([[matrix]], [shape], torch.float32, "cpu")
    np.testing.assert_allclose(own.inv, spec_j.inv, rtol=1e-6, atol=1e-9)
    rj, rt = _f32(np.random.default_rng(4).standard_normal(shape))
    expected = np.asarray(spec_j.apply((rj,))[0])
    np.testing.assert_allclose(spec_t.apply((rt,))[0].numpy(), expected, rtol=1e-5,
                               atol=1e-5 * np.abs(expected).max())


@pytest.mark.parametrize("period", [(2, 2), (3, 1), (2, 3)])
def test_block_solve_paths_match_reference(period):
    shape = (15, 15)

    def block_stencil(side):
        # Keep only couplings inside one block, as the grammar's
        # block-diagonal filter does, as a periodic stencil over the block.
        stencil = side.gallery.Poisson2D().generate_stencil(_grid(15, side))
        cells = np.empty(period, dtype=object)
        for alpha in np.ndindex(*period):
            cells[alpha] = side.constant.Stencil([
                (o, v) for o, v in stencil.entries
                if all(0 <= a + oo < p for a, oo, p in zip(alpha, o, period))
            ])
        return side.periodic.PeriodicStencil(cells)

    spec_j = jsm.build_block_solve_spec(
        [[block_stencil(REFERENCE)]], [period], shape, jnp.float32)
    spec_t = interop.block_solve_spec_from_reference(spec_j, "cpu", torch.float32)
    own = smoothers.build_block_solve_spec(
        [[block_stencil(PORT)]], [period], shape, torch.float32, "cpu")
    np.testing.assert_allclose(own.inv_l, spec_j.inv_l, rtol=1e-6, atol=1e-9)
    rj, rt = _f32(np.random.default_rng(5).standard_normal(shape))
    scale = max(1.0, float(np.abs(np.asarray(rj)).max()) * float(np.abs(spec_j.inv_l).max()))
    for name in ("apply", "apply_masked", "apply_matmul"):
        expected = np.asarray(getattr(spec_j, name)((rj,))[0])
        got = getattr(spec_t, name)((rt,))[0].numpy()
        np.testing.assert_allclose(got / scale, expected / scale, atol=1e-5, err_msg=name)


def test_point_smoothers_match_reference():
    shape = (15, 15)
    rng = np.random.default_rng(6)
    (aj, at), (bj, bt) = _f32(rng.standard_normal(shape)), _f32(rng.standard_normal(shape))
    inv = np.array([[0.25, -0.5], [0.0, 2.0]])
    for got, expected in zip(
        smoothers.collective_jacobi_apply((at, bt), inv),
        jsm.collective_jacobi_apply((aj, bj), inv),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-6)
    planes = [[np.full(shape, 0.25), None], [np.full(shape, -1.5), np.full(shape, 2.0)]]
    for got, expected in zip(
        smoothers.collective_jacobi_apply_variable(
            (at, bt), [[None if p is None else torch.from_numpy(p.astype(np.float32)) for p in row]
                       for row in planes]),
        jsm.collective_jacobi_apply_variable(
            (aj, bj), [[None if p is None else jnp.asarray(p, dtype=jnp.float32) for p in row]
                       for row in planes]),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-6)
    for got, expected in zip(
        smoothers.decoupled_jacobi_apply((at, bt), [0.25, 0.5]),
        jsm.decoupled_jacobi_apply((aj, bj), [0.25, 0.5]),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), atol=1e-6)
