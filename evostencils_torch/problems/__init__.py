from evostencils_torch.problems.api import Problem  # noqa: F401
from evostencils_torch.problems import poisson  # noqa: F401

from evostencils_torch import NotPortedError

# The names evostencils_tpu.problems.build_named_problem knows.
_REFERENCE_NAMES = ("poisson2d", "poisson3d", "poisson2d_var", "elasticity", "helmholtz", "fas")


def build_named_problem(name: str, min_level: int = 5, max_level: int = 9):
    """Problem registry for the entry scripts (scripts/torch_optimize.py).
    Only 2D Poisson is ported; the reference's other names raise
    NotPortedError, unknown names ValueError."""
    if name == "poisson2d":
        return poisson.poisson_2d(min_level, max_level)
    if name in _REFERENCE_NAMES:
        raise NotPortedError(f"problem family {name!r}")
    raise ValueError(f"Unknown problem {name!r}")


def load_problem_file(path: str, knowledge_path: str = None, dtype=None):
    """The reference loads .exa2/.exa3/.exa4 specs through
    problems/parser.py, which is not ported."""
    raise NotPortedError("problem files (problems/parser.py)")
