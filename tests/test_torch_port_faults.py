"""Two faults the port had against the JAX package, held repaired.

* A device fault while timing the restarted (float64) measurement kept
  nothing: the fitness was (∞, ∞, ∞).  The reference keeps the measured ρ
  and count and poisons only the time (evostencils_tpu/backend/
  evaluation.py:1289-1297).  Here `_median_time` raises
  `torch.cuda.OutOfMemoryError` on the CPU: the fitness must be
  (∞, ρ, iterations) with ρ and iterations equal to an unfaulted run.
* The sweep kernel's gate against the reference's Pallas gate
  (pallas_kernels.py:119-138) on a table of shapes, stencils and dtypes:
  equal everywhere except radius > 4 at ≤ 512² cells, which the reference
  takes and the port's kernel (instantiated for radius ≤ 4) leaves to the
  plain half-sweeps.
"""

import jax.numpy as jnp
import pytest
import torch

from evostencils_tpu.ops.pallas_kernels import supports_rb_sweep as jax_supports_rb_sweep
from evostencils_tpu.stencils import constant as jax_constant
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ir import reference_cycles
from evostencils_torch.ops import rb_sweep
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant
from tests.torch_parity import PORT, Side

INFINITY = 1e100


def test_device_fault_while_timing_keeps_rho_and_iterations(monkeypatch):
    problem = poisson_2d(3, 5, dtype=torch.float64)
    side = Side(PORT, problem)
    cycle = reference_cycles.generate_v_cycle(side.terminals, problem.rhs(), 2, 1)
    generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    t, rho, iterations = generator.generate_and_evaluate(cycle, evaluation_samples=1)
    assert t < INFINITY and 0.0 < rho < 1.0

    def out_of_memory(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("out of memory while timing")

    faulted = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(faulted, "_median_time", out_of_memory)
    assert faulted.generate_and_evaluate(cycle, evaluation_samples=1) == (INFINITY, rho, iterations)
    assert faulted._consecutive_device_failures == 1


def _stencils(package_constant):
    star = (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0))
    return {
        "5-point": package_constant.Stencil(star),
        "radius-4": package_constant.Stencil(star + (((4, -3), -0.1),)),
        "radius-5": package_constant.Stencil(star + (((5, 0), -0.1),)),
        "radius-9": package_constant.Stencil(star + (((0, -9), -0.1),)),
        "complex": package_constant.Stencil((((0, 0), 4.0 + 1.0j), ((1, 0), -1.0))),
    }


SHAPES = [(15, 15), (31, 17), (511, 511), (512, 512), (513, 511), (1023, 1023), (100, 3000),
          (128, 4000), (129, 4000), (2048, 2048), (16384, 16384), (16385, 16384),
          (32768, 32768)]
DTYPES = ((torch.float32, jnp.float32), (torch.float64, jnp.float64))


@pytest.mark.parametrize("name", ["5-point", "radius-4", "radius-5", "radius-9", "complex"])
def test_sweep_gate_matches_reference(name):
    port_stencil, jax_stencil = _stencils(constant)[name], _stencils(jax_constant)[name]
    for shape in SHAPES:
        for torch_dtype, jax_dtype in DTYPES:
            port = rb_sweep.supports_rb_sweep(shape, port_stencil, torch_dtype)
            reference = jax_supports_rb_sweep(shape, jax_stencil, jax_dtype)
            wide = name in ("radius-5", "radius-9") and shape[0] * shape[1] <= 512 * 512
            if wide and torch_dtype == torch.float32:
                # A difference of route: the plain half-sweeps take it.
                assert reference and not port, (name, shape)
            else:
                assert port == reference, (name, shape, torch_dtype, port, reference)


def test_sweep_gate_refuses_3d_as_reference():
    entries = (((0, 0, 0), 6.0), ((1, 0, 0), -1.0), ((0, 0, -1), -1.0))
    for torch_dtype, jax_dtype in DTYPES:
        assert not rb_sweep.supports_rb_sweep((15, 15, 15), constant.Stencil(entries), torch_dtype)
        assert not jax_supports_rb_sweep((15, 15, 15), jax_constant.Stencil(entries), jax_dtype)
