"""Copy of evostencils_tpu/stencils/: the same modules, importing the port's
copies in place of the reference's."""

from evostencils_torch.stencils import constant, periodic, gallery  # noqa: F401
