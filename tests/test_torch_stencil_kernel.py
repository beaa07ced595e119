"""The constant-stencil kernel (csrc/stencil2d.cu, ops/stencil_kernel.py):
its gate, its packing and its counters on the CPU, and on the card its
output against the plain torch chain bit for bit.

The card tests carry the `cuda` marker and skip without an NVIDIA GPU.  The
file imports nothing of JAX, so on the machine with the card it runs as

    python -m pytest --noconftest -m "cuda and not slow" tests/test_torch_stencil_kernel.py -q
"""

import collections
import contextlib
import os

import numpy as np
import pytest
import torch

from evostencils_torch.backend import graphs
from evostencils_torch.ops import intergrid, rb_sweep, stencil_kernel
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.stencils import constant, gallery, periodic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def unsorted(entries, seed: int) -> constant.Stencil:
    """A stencil whose entries are in a seeded order, not the sorted one
    that the constructor gives: the kernel must follow `entries`."""
    stencil = constant.Stencil(entries)
    order = np.random.default_rng(seed).permutation(stencil.number_of_entries)
    stencil._entries = tuple(stencil.entries[i] for i in order)
    return stencil


STENCILS = {
    "5-point": constant.Stencil(
        (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0))),
    "9-point": constant.Stencil(
        [((i, j), 8.0 / 3 if (i, j) == (0, 0) else -1 / 3) for i in (-1, 0, 1) for j in (-1, 0, 1)]),
    "radius-2": unsorted(
        (((0, 0), 2.5), ((2, -1), -0.5), ((-2, 1), 0.75), ((0, 2), -0.25), ((1, 0), -0.1),
         ((-1, -2), 1 / 7)), seed=1),
    "radius-4": unsorted(
        (((0, 0), 4.0), ((1, 0), -1.5), ((-1, 0), -0.5), ((0, 1), -0.75), ((0, -2), -0.25),
         ((2, -1), 0.125), ((-4, 3), -0.0625), ((3, 4), 0.1), ((4, -4), 1 / 3)), seed=2),
}
TRANSFERS = {
    "full-weighting": gallery.full_weighting_restriction_stencil(2),
    "bilinear": gallery.multilinear_interpolation_stencil(2),
    "radius-2": STENCILS["radius-2"],
}


@contextlib.contextmanager
def counts_cleared():
    stencil_kernel.clear_counts()
    try:
        yield
    finally:
        stencil_kernel.clear_counts()


# ---------------------------------------------------------------------------
# CPU: the gate, the packing, the counters.
# ---------------------------------------------------------------------------


class OnCard:
    """A field's metadata as a CUDA tensor shows it, without a card: a meta
    tensor that reports a CUDA device.  The gate reads nothing else."""

    def __init__(self, shape, dtype=torch.float32, requires_grad=False):
        self._t = torch.empty(shape, dtype=dtype, device="meta", requires_grad=requires_grad)
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _variable_stencil():
    cells = np.empty((2, 2), dtype=object)
    for index in np.ndindex(2, 2):
        cells[index] = constant.Stencil([((0, 0), 4.0 + sum(index)), ((1, 0), -1.0)])
    return periodic.PeriodicStencil(cells)


REFUSED = {
    "cpu": (lambda: (torch.zeros(15, 15), STENCILS["5-point"], {}), "cpu"),
    "complex field": (lambda: (OnCard((15, 15), torch.complex128), STENCILS["5-point"], {}),
                      "dtype"),
    "half field": (lambda: (OnCard((15, 15), torch.float16), STENCILS["5-point"], {}), "dtype"),
    "complex stencil": (lambda: (OnCard((15, 15)), constant.Stencil(
        [((0, 0), 4.0 + 0.5j), ((1, 0), -1.0)]), {}), "stencil"),
    "3D": (lambda: (OnCard((15, 15, 15)), gallery.Poisson3D().generate_stencil(
        _grid3d()), {}), "dimension"),
    "two member axes": (lambda: (OnCard((2, 3, 15, 15)), STENCILS["5-point"], {}), "dimension"),
    "slab": (lambda: (OnCard((15, 15)), STENCILS["5-point"], {"slab": object()}), "slab"),
    "variable": (lambda: (OnCard((15, 15)), _variable_stencil(), {}), "stencil"),
    "too many entries": (lambda: (OnCard((15, 15)), constant.Stencil(
        [((i, j), 1.0 + i + 7 * j) for i in range(-3, 4) for j in range(-3, 4)]), {}),
        "entries"),
    "empty": (lambda: (OnCard((15, 15)), constant.Stencil([], dimension=2), {}), "entries"),
    "radius above 4": (lambda: (OnCard((15, 15)), constant.Stencil(
        [((0, 0), 2.0), ((5, 0), -1.0)]), {}), "radius"),
    "recorded by autograd": (lambda: (OnCard((15, 15), requires_grad=True),
                                      STENCILS["5-point"], {}), "grad"),
    "no members": (lambda: (OnCard((0, 15, 15)), STENCILS["5-point"], {}), "shape"),
    "transfer off the lattice": (lambda: (OnCard((3, 15, 15)), TRANSFERS["full-weighting"], {
        "fine_shape": (15, 15), "coarse_shape": (8, 8), "coarsening": (2, 2)}), "shape"),
}


def _grid3d():
    from evostencils_torch.ir import base
    return base.Grid((16, 16, 16), (1 / 16,) * 3, 4)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_gate_refuses_with_its_reason(case):
    make, reason = REFUSED[case]
    x, stencil, kwargs = make()
    assert stencil_kernel.refusal(x, stencil, **kwargs) == reason


ACCEPTED = {
    "5-point f32": (lambda: OnCard((511, 511)), STENCILS["5-point"], {}),
    "9-point f64": (lambda: OnCard((63, 127), torch.float64), STENCILS["9-point"], {}),
    "radius-4 members": (lambda: OnCard((8, 31, 31)), STENCILS["radius-4"], {}),
    "25 entries": (lambda: OnCard((31, 31)), constant.Stencil(
        [((i, j), 1.0) for i in range(-2, 3) for j in range(-2, 3)]), {}),
    "restriction": (lambda: OnCard((3, 511, 511)), TRANSFERS["full-weighting"], {
        "fine_shape": (511, 511), "coarse_shape": (255, 255), "coarsening": (2, 2)}),
    "semi-coarsened": (lambda: OnCard((63, 31)), TRANSFERS["bilinear"], {
        "fine_shape": (63, 31), "coarse_shape": (31, 31), "coarsening": (2, 1)}),
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_gate_accepts(case):
    make, stencil, kwargs = ACCEPTED[case]
    assert stencil_kernel.refusal(make(), stencil, **kwargs) is None


def test_gate_takes_a_field_that_requires_grad_without_grad_mode():
    with torch.no_grad():
        assert stencil_kernel.refusal(
            OnCard((15, 15), requires_grad=True), STENCILS["5-point"]) is None


# Ties of float32 rounding (1 + 2^-24 rounds to even: 1; 1 + 3·2^-24 up),
# values that float32 cannot hold exactly, a float32 subnormal, a sign.
ROUNDING_VALUES = (1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24, 1 / 3, -0.1, 1e-40, -262144.0, 2 / 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packing_keeps_the_entry_order_and_rounds_as_torch(dtype):
    offsets = ((0, 0), (1, -1), (-4, 3), (2, 2), (0, -3), (-1, 0), (3, -4))
    stencil = unsorted(tuple(zip(offsets, ROUNDING_VALUES)), seed=5)
    count, packed_offsets, weights = stencil_kernel.packed(stencil, dtype)
    assert count == stencil.number_of_entries
    assert list(packed_offsets) == [o for offset in stencil.offsets for o in offset]
    # torch's rounding of a Python scalar times a tensor of `dtype`.
    rounded = [(torch.ones((), dtype=dtype) * sops.scalar(v)).item() for v in stencil.values]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    assert np.array_equal(np.asarray(weights[:count], np_dtype).view(np.uint8),
                          np.asarray(rounded, np_dtype).view(np.uint8))
    if dtype == torch.float32:
        # The two ties round apart, so the order is checked on the values too.
        assert weights[stencil.offsets.index((0, 0))] == 1.0


def _plain_restrict(fine, stencil, coarse_shape, coarsening):
    """coarse[ci] = Σ w·fine[c(ci+1)-1+o] by a loop over numpy points."""
    out = np.zeros(coarse_shape, dtype=np.float64)
    for ci in np.ndindex(*coarse_shape):
        for offset, w in stencil.entries:
            z = tuple(c * (i + 1) - 1 + o for c, i, o in zip(coarsening, ci, offset))
            if all(0 <= zi < n for zi, n in zip(z, fine.shape)):
                out[ci] += w * fine[z]
    return out


def test_cpu_calls_take_the_plain_path_and_count_once():
    rng = np.random.default_rng(0)
    fine = torch.from_numpy(rng.standard_normal((15, 15)))
    coarse = torch.from_numpy(rng.standard_normal((7, 7)))
    with counts_cleared():
        applied = sops.apply_constant_stencil(fine, STENCILS["5-point"])
        restricted = intergrid.restrict(fine, TRANSFERS["full-weighting"], (7, 7), (2, 2))
        prolonged = intergrid.prolong(coarse, TRANSFERS["bilinear"], (15, 15), (2, 2))
        assert stencil_kernel.plain == {"cpu": 3} and not stencil_kernel.launches
    assert torch.equal(applied, sops.plain_constant_stencil(fine, STENCILS["5-point"]))
    assert np.allclose(restricted.numpy(), _plain_restrict(
        fine.numpy(), TRANSFERS["full-weighting"], (7, 7), (2, 2)), rtol=0, atol=1e-14)
    assert torch.equal(prolonged, sops.plain_constant_stencil(
        intergrid.inject_to_fine(coarse, (15, 15), (2, 2)), TRANSFERS["bilinear"]))


# ---------------------------------------------------------------------------
# The card: the kernel against the plain chain, bit for bit.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def gate_refused(monkeypatch):
    """The plain chain everywhere: the test's own refusal, no switch in the
    program."""
    with monkeypatch.context() as patch:
        patch.setattr(stencil_kernel, "refusal", lambda *args, **kwargs: "test")
        yield


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def assert_same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want))


def field(shape, members, dtype, device, seed):
    """A seeded field with exact zeros and negative zeros in it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(((members,) if members else ()) + tuple(shape))
    x[..., ::7, ::5] = 0.0
    x[..., 3::11, 1::4] = -0.0
    return torch.from_numpy(x).to(dtype=dtype, device=device)


DTYPES = [torch.float32, torch.float64]
SHAPES = [(31, 31), (63, 127), (255, 255), (127, 511), (511, 511), (1023, 1023)]
MEMBERS = [0, 1, 3, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("members", MEMBERS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(STENCILS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_matches_the_plain_chain_bit_for_bit(cuda, monkeypatch, dtype, name, shape,
                                                   members):
    u = field(shape, members, dtype, cuda, seed=sum(shape) + members)
    stencil = STENCILS[name]
    with counts_cleared():
        got = sops.apply_constant_stencil(u, stencil)
        assert stencil_kernel.launches == {("apply", tuple(u.shape)): 1}
        assert not stencil_kernel.plain
    with gate_refused(monkeypatch):
        want = sops.apply_constant_stencil(u, stencil)
    torch.cuda.synchronize()
    assert_same_bits(got, want)


TRANSFER_SHAPES = [((31, 31), (15, 15), (2, 2)), ((63, 127), (31, 63), (2, 2)),
                   ((511, 511), (255, 255), (2, 2)), ((1023, 1023), (511, 511), (2, 2)),
                   ((63, 31), (31, 31), (2, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("members", MEMBERS)
@pytest.mark.parametrize("shapes", TRANSFER_SHAPES, ids=lambda s: "x".join(map(str, s[0])))
@pytest.mark.parametrize("name", sorted(TRANSFERS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_restrict_and_prolong_match_the_plain_chain_bit_for_bit(cuda, monkeypatch, dtype, name,
                                                                shapes, members):
    fine_shape, coarse_shape, coarsening = shapes
    stencil = TRANSFERS[name]
    fine = field(fine_shape, members, dtype, cuda, seed=1)
    coarse = field(coarse_shape, members, dtype, cuda, seed=2)
    with counts_cleared():
        restricted = intergrid.restrict(fine, stencil, coarse_shape, coarsening)
        prolonged = intergrid.prolong(coarse, stencil, fine_shape, coarsening)
        assert stencil_kernel.launches == {("restrict", tuple(restricted.shape)): 1,
                                           ("prolong", tuple(prolonged.shape)): 1}
        assert not stencil_kernel.plain
    with gate_refused(monkeypatch):
        want_restricted = intergrid.restrict(fine, stencil, coarse_shape, coarsening)
        want_prolonged = intergrid.prolong(coarse, stencil, fine_shape, coarsening)
    torch.cuda.synchronize()
    assert_same_bits(restricted, want_restricted)
    assert_same_bits(prolonged, want_prolonged)


def _champion_cycle(dtype, device):
    from evostencils_torch.backend.lowering import CycleLowering
    from evostencils_torch.grammar import gp
    from evostencils_torch.grammar.multigrid import generate_primitive_set
    from evostencils_torch.problems.poisson import poisson_2d
    from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file

    problem = poisson_2d(5, 9, dtype=dtype)
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields, depth=4,
        maximum_local_system_size=8)
    tree_string, omegas = parse_champion_file(
        os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt"))
    champion = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
    assert apply_stored_omegas(champion, omegas, label="test champion")
    return CycleLowering(dtype, device).lower(champion)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_lowered_champion_cycle_matches_the_plain_chain_bit_for_bit(cuda, monkeypatch, dtype):
    step = _champion_cycle(dtype, cuda)
    u0 = (field((511, 511), 0, dtype, cuda, seed=3),)
    f = (field((511, 511), 0, dtype, cuda, seed=4),)
    with counts_cleared():
        got = step(u0, f)
        got = step(got, f)
        torch.cuda.synchronize()
        modes = {mode for mode, _ in stencil_kernel.launches}
        assert modes == {"apply", "restrict", "prolong"} and not stencil_kernel.plain
    with gate_refused(monkeypatch), counts_cleared():
        want = step(u0, f)
        want = step(want, f)
        torch.cuda.synchronize()
        assert not stencil_kernel.launches
    for a, b in zip(got, want):
        assert_same_bits(a, b)


@pytest.mark.cuda
def test_graph_replays_give_the_same_bits_and_count_each_launch(cuda, monkeypatch):
    fine = {d: field((255, 255), 3, d, cuda, seed=7) for d in DTYPES}
    coarse = {d: field((127, 127), 3, d, cuda, seed=8) for d in DTYPES}
    helmholtz = torch.complex(fine[torch.float64], fine[torch.float64].flip(-1))
    five, fw, bilinear = STENCILS["5-point"], TRANSFERS["full-weighting"], TRANSFERS["bilinear"]

    def body():
        out = []
        for d in DTYPES:
            out.append(sops.apply_constant_stencil(fine[d], five))
            out.append(intergrid.restrict(fine[d], fw, (127, 127), (2, 2)))
            out.append(intergrid.prolong(coarse[d], bilinear, (255, 255), (2, 2)))
        out.append(sops.apply_constant_stencil(helmholtz, five))  # refused: complex
        return out

    with gate_refused(monkeypatch):
        want = body()
    rb_sweep.clear_counts()
    with counts_cleared():
        graph, got = graphs.capture(body)
        stencil_kernel.clear_counts()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        expected = collections.Counter()
        for d in DTYPES:
            expected[("apply", (3, 255, 255))] += 3
            expected[("restrict", (3, 127, 127))] += 3
            expected[("prolong", (3, 255, 255))] += 3
        assert stencil_kernel.launches == expected
        assert stencil_kernel.plain == {"dtype": 3}
    assert not rb_sweep.launches
    for a, b in zip(got, want):
        if a.is_complex():
            assert torch.equal(a, b)
        else:
            assert_same_bits(a, b)
