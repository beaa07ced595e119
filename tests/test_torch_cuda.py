"""The CUDA kernel against its plain torch version, on a card.

These tests need an NVIDIA GPU (sm_90a) and skip without one.  The file
imports nothing of JAX, so it runs on the machine with the card, where
JAX is not installed (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir import reference_cycles
from evostencils_torch.ops import rb_sweep
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant

ENTRIES = {
    "5-point": (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0)),
    # Same-colour diagonal coupling: catches an update in place within a colour.
    "9-point": (((0, 0), 8.0 / 3), ((1, 0), -1 / 3), ((-1, 0), -1 / 3), ((0, 1), -1 / 3),
                ((0, -1), -1 / 3), ((1, 1), -1 / 3), ((1, -1), -1 / 3), ((-1, 1), -1 / 3),
                ((-1, -1), -1 / 3)),
    # Radius 1, neither the 5-point nor the 9-point pattern: the kernel's
    # generic radius-1 instance.
    "skew": (((0, 0), 2.0), ((1, 1), -0.5), ((-1, 0), -0.25), ((0, -1), -0.25)),
    "radius-2": (((0, 0), 2.5), ((2, -1), -0.5), ((-2, 1), 0.75), ((0, 2), -0.25), ((1, 0), -0.5)),
    # No symmetry, radius 4: a sign or axis error in the offsets shows up here.
    "asymmetric": (((0, 0), 4.0), ((1, 0), -1.5), ((-1, 0), -0.5), ((0, 1), -0.75),
                   ((0, -2), -0.25), ((2, -1), 0.125), ((-4, 3), -0.0625), ((3, 4), 0.1)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRIES))
@pytest.mark.parametrize(
    "shape", [(31, 31), (63, 63), (127, 127), (255, 255), (511, 511), (1023, 1023), (161, 96)])
def test_kernel_matches_plain_version(cuda, name, shape):
    # Every level size of the 511² and 1023² configurations (both block
    # shapes of csrc/rb_sweep.cu: launch_shape) and a ragged grid, with a
    # stencil for every instance of the kernel; max|Δ| < 5e-5, as
    # tests/test_pallas.py holds the Pallas kernels.
    stencil = constant.Stencil(ENTRIES[name])
    rng = np.random.default_rng(3)
    u, f = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
            for _ in range(2))
    before = rb_sweep.launches.total(), rb_sweep.launches[shape]
    out = rb_sweep.red_black_collective_jacobi_sweep(u, f, 1.15, stencil)
    torch.cuda.synchronize()
    assert (rb_sweep.launches.total(), rb_sweep.launches[shape]) == (before[0] + 1, before[1] + 1)
    assert float((out - rb_sweep.rb_sweep_reference(u, f, 1.15, stencil)).abs().max()) < 5e-5


@pytest.mark.cuda
def test_v22_cycle_on_the_card_launches_the_kernel_and_matches_the_cpu(cuda):
    problem = poisson_2d(3, 5, dtype=torch.float32)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=1, maximum_local_system_size=4,
    )
    cycle = reference_cycles.generate_v_22_cycle_two_grid(terminals[0], problem.rhs())
    u0, f = problem.initial_state(torch.float32, device="cpu")
    expected = CycleLowering(torch.float32, "cpu").lower(cycle)(u0, f)[0]
    before = rb_sweep.launches.total()
    got = CycleLowering(torch.float32, cuda).lower(cycle)(
        tuple(x.to(cuda) for x in u0), tuple(x.to(cuda) for x in f))[0]
    torch.cuda.synchronize()
    assert rb_sweep.launches.total() == before + 4  # two pre- and two post-smoothing steps
    scale = float(expected.abs().max())
    assert float((got.cpu() - expected).abs().max()) / scale < 1e-5
