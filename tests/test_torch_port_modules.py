"""The port's own copies of the reference's array-free layers (stencils,
IR, grammar, champions) against the reference's, on the CPU.

The port imports nothing of `evostencils_tpu`, so its IR objects are not
the reference's: each side is built through its own package, from the
same seed or the same string, and the results must be identical (the
copies differ only in their import paths, so nothing may round apart).
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.grammar import gp as jax_gp
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import base as jax_base
from evostencils_tpu.ir import transformations as jax_transformations
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.stencils import constant as jax_constant
from evostencils_tpu.stencils import gallery as jax_gallery
from evostencils_tpu.utils import champions as jax_champions
from evostencils_torch.grammar import gp, multigrid
from evostencils_torch.ir import base, transformations
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant, gallery
from evostencils_torch.utils import champions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")


def _bench_trees(problem, gp_module, grammar):
    """The bench protocol's trees: 2D Poisson levels 5-9, a depth-4
    grammar, 16 trees from random.Random(20260816) (chip_smoke.py)."""
    pset, _ = grammar.generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=4, maximum_local_system_size=8,
    )
    rng = random.Random(20260816)
    trees = [gp_module.gen_grow(pset, 2, 16, rng=rng) for _ in range(16)]
    return pset, trees


def test_bench_protocol_trees_and_their_ir_match_the_reference():
    jax_pset, jax_trees = _bench_trees(
        jax_poisson_2d(5, 9, dtype=jnp.float32), jax_gp, jax_multigrid)
    pset, trees = _bench_trees(poisson_2d(5, 9, dtype=torch.float32), gp, multigrid)
    assert [str(t) for t in trees] == [str(t) for t in jax_trees]
    for tree, jax_tree in zip(trees, jax_trees):
        expr = gp.compile_tree(tree, pset)[0]
        jax_expr = jax_gp.compile_tree(jax_tree, jax_pset)[0]
        assert isinstance(expr, base.Expression)
        assert not isinstance(expr, jax_base.Expression)
        assert transformations.canonical_string(expr) == jax_transformations.canonical_string(
            jax_expr)
        # The same string parses back to the same IR on the port's side.
        reparsed = gp.compile_tree(gp.parse_tree(str(tree), pset), pset)[0]
        assert transformations.canonical_string(reparsed) == transformations.canonical_string(expr)


@pytest.mark.parametrize("level", range(3, 10))
def test_gallery_stencils_match_the_reference(level):
    n = 2**level

    def stencils(grid_class, constant_module, gallery_module):
        grid = grid_class((n, n), (1.0 / n, 1.0 / n), level)
        five = gallery_module.Poisson2D().generate_stencil(grid)
        return {
            "5-point": five,
            "5-point anisotropic": gallery_module.Poisson2D(0.01).generate_stencil(grid),
            # Full weighting: the 9-point stencil of the gallery's transfers.
            "9-point": gallery_module.full_weighting_restriction_stencil(2),
            "interpolation": gallery_module.multilinear_interpolation_stencil(2),
            # The stencil algebra on the 5-point stencil: a 13-point product
            # and the inverse of its diagonal.
            "5-point squared": constant_module.mul(five, five),
            "inverse diagonal": constant_module.inverse(constant_module.diagonal(five)),
        }

    expected = stencils(jax_base.Grid, jax_constant, jax_gallery)
    got = stencils(base.Grid, constant, gallery)
    assert got.keys() == expected.keys()
    for name in got:
        assert isinstance(got[name], constant.Stencil), name
        assert got[name].entries == expected[name].entries, name
    assert got["9-point"].number_of_entries == 9


def test_champion_file_parses_the_same():
    tree_string, omegas = champions.parse_champion_file(CHAMPION)
    assert (tree_string, omegas) == jax_champions.parse_champion_file(CHAMPION)
    assert tree_string and omegas and all(isinstance(w, float) for w in omegas)
    assert champions.omega_index(1.15) == jax_champions.omega_index(1.15)
    # The stored ω land in the same cycles on both sides.
    results = []
    for problem, gp_module, grammar in (
        (poisson_2d(5, 9, dtype=torch.float32), gp, multigrid),
        (jax_poisson_2d(5, 9, dtype=jnp.float32), jax_gp, jax_multigrid),
    ):
        pset, _ = grammar.generate_primitive_set(
            problem.approximation(), problem.rhs(), problem.dimension,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=4, maximum_local_system_size=8,
        )
        expr = gp_module.compile_tree(gp_module.parse_tree(tree_string, pset), pset)[0]
        module = champions if gp_module is gp else jax_champions
        assert module.apply_stored_omegas(expr, omegas, label="parity test")
        results.append(expr)
    cycles = transformations.collect_cycles(results[0])
    jax_cycles = jax_transformations.collect_cycles(results[1])
    np.testing.assert_array_equal(
        [c.relaxation_factor for c in cycles], [c.relaxation_factor for c in jax_cycles])
    assert transformations.canonical_string(results[0]) == jax_transformations.canonical_string(
        results[1])
