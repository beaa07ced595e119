"""Copy of evostencils_tpu/ir/: the same modules, importing the port's
copies in place of the reference's."""

from evostencils_torch.ir import base, system, smoother, krylov, partitioning  # noqa: F401
