from evostencils_torch.problems.api import Problem  # noqa: F401
from evostencils_torch.problems import poisson  # noqa: F401
