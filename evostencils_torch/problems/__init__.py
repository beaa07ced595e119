from evostencils_torch.problems.api import Problem  # noqa: F401
import os

from evostencils_torch.problems import elasticity, fas, helmholtz, parser, poisson  # noqa: F401


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
    """Load a problem spec by file extension: .exa2 (layer 2), .exa3
    (layer-3 configs with a hand-written outer solver), .exa4 (layer-4 FAS
    templates).  Without `knowledge_path`, the `.knowledge` file beside
    the spec is used when there is one (for a `*_template` spec, also the
    name without `_template`)."""
    if knowledge_path is None:
        for candidate in (
            path.rsplit(".", 1)[0] + ".knowledge",
            path.replace("_template", "").rsplit(".", 1)[0] + ".knowledge",
        ):
            if os.path.isfile(candidate):
                knowledge_path = candidate
                break
    ext = path.rsplit(".", 1)[-1]
    if ext == "exa2":
        return parser.parse_exa2(path, knowledge_path, dtype=dtype)
    if ext == "exa3":
        return parser.parse_exa3(path, knowledge_path, dtype=dtype)
    if ext == "exa4":
        return parser.parse_exa4(path, knowledge_path, dtype=dtype)
    raise ValueError(f"Unknown problem file extension: {path}")
