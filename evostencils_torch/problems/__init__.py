from evostencils_torch.problems.api import Problem  # noqa: F401
from evostencils_torch.problems import elasticity, fas, helmholtz, poisson  # noqa: F401

from evostencils_torch import NotPortedError


def build_named_problem(name: str, min_level: int = 5, max_level: int = 9):
    """Problem registry for the entry scripts (scripts/torch_optimize.py),
    with the reference's level mapping: 3D runs two levels lower, capped at
    7; elasticity is capped at 8; FAS and Helmholtz keep their own ranges."""
    if name == "poisson2d":
        return poisson.poisson_2d(min_level, max_level)
    if name == "poisson3d":
        return poisson.poisson_3d(min_level=max(2, min_level - 2), max_level=min(max_level, 7))
    if name == "poisson2d_var":
        return poisson.poisson_2d_variable(min_level, max_level)
    if name == "elasticity":
        return elasticity.linear_elasticity_2d(min_level, min(max_level, 8))
    if name == "helmholtz":
        return helmholtz.helmholtz_2d(min_level=3, max_level=7)
    if name == "fas":
        return fas.fas_2d(min_level=5, max_level=9)
    raise ValueError(f"Unknown problem {name!r}")


def load_problem_file(path: str, knowledge_path: str = None, dtype=None):
    """The reference loads .exa2/.exa3/.exa4 specs through
    problems/parser.py, which is not ported."""
    raise NotPortedError("problem files (problems/parser.py)")
