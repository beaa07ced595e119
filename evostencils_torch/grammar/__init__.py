"""Copy of evostencils_tpu/grammar/: the same modules, importing the port's
copies in place of the reference's."""

from evostencils_torch.grammar import gp, multigrid, typing  # noqa: F401
