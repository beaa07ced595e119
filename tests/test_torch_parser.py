"""The port's problem-file parser against the JAX package's on the CPU.

The same spec text goes to evostencils_tpu.problems.parser and to
evostencils_torch.problems.parser, for each of the four specs under
artifacts/problem_specs/ and for one spec written inside this file, and
the two `Problem`s must agree:

* fields, levels, constants, parameters, equations, operator names and
  kinds, `uses_fas`, `residual_target`, `iteration_limit`: equal;
* every operator's stencil entries at every level: equal, exactly (both
  run the same sympy arithmetic);
* the right-hand side on `interior_coordinates`: atol 1e-12 in float64;
* the outer solver's target, cap and its operator's stencil: equal;
* the FAS Jacobian, `nonlinear_term` and `derivative_diag` on the same
  seeded u: rtol 1e-12 in float64 (jax.numpy against torch).

Each parsed spec is also held against the port's hand-written problem, as
tests/test_aux.py holds the reference's files against the reference's
problems.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.problems import load_problem_file as jax_load_problem_file
from evostencils_tpu.problems import parser as jax_parser
from evostencils_torch.problems import fas, helmholtz, load_problem_file, parser, poisson
from evostencils_torch.problems.elasticity import linear_elasticity_2d
from evostencils_torch.stencils import gallery, periodic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "artifacts", "problem_specs")
SPEC_FILES = [
    "2D_FD_Poisson_fromL2.exa2",
    "2D_FD_LinearElasticity_fromL2.exa2",
    "2D_FD_Helmholtz_fromL3.exa3",
    "FAS_2D_Basic_template.exa4",
]
ANISOTROPIC_SPEC = """
// Anisotropic 2D Poisson: -eps·u_xx - u_yy = f.
Globals {
  Expr eps = 0.25
}
u with Real on Node of global = 0.0
RHS_u with Real on Node of global = sin ( PI * vf_nodePos_x ) * vf_nodePos_y
Laplace from Stencil {
  [ 0,  0] => 2.0 * eps / ( vf_gridWidth_x ** 2 ) + 2.0 / ( vf_gridWidth_y ** 2 )
  [ 1,  0] => -eps / ( vf_gridWidth_x ** 2 )
  [-1,  0] => -eps / ( vf_gridWidth_x ** 2 )
  [ 0,  1] => -1.0 / ( vf_gridWidth_y ** 2 )
  [ 0, -1] => -1.0 / ( vf_gridWidth_y ** 2 )
}
uEquation {
  Laplace * u == RHS_u
}
"""
ANISOTROPIC_KNOWLEDGE = "dimensionality = 2\nminLevel = 2\nmaxLevel = 4\n"


def both(path):
    return jax_load_problem_file(path), load_problem_file(path)


def stencil_entries(generator, grid):
    return generator.generate_stencil(grid).entries


def assert_same_problem(reference, problem):
    for key in ("name", "dimension", "min_level", "max_level", "field_names",
                "equation_strings", "constants", "parameters", "uses_fas",
                "residual_target", "iteration_limit"):
        assert getattr(problem, key) == getattr(reference, key), key
    assert np.dtype(jnp.dtype(reference.dtype)).name == str(problem.dtype).split(".")[1]
    assert list(problem.operator_factories) == list(reference.operator_factories)
    for name, (factory, kind) in problem.operator_factories.items():
        reference_factory, reference_kind = reference.operator_factories[name]
        assert kind.__name__ == reference_kind.__name__, name
        for level in range(problem.min_level, problem.max_level + 1):
            grid = problem.grid_at(level)[0]
            assert stencil_entries(factory(level, problem.parameters), grid) == stencil_entries(
                reference_factory(level, reference.parameters), reference.grid_at(level)[0]
            ), (name, level)
    assert (problem.rhs_functions is None) == (reference.rhs_functions is None)
    if problem.rhs_functions is not None:
        coordinates = problem.interior_coordinates(problem.min_level + 1)
        for mine, theirs in zip(problem.rhs_functions, reference.rhs_functions):
            np.testing.assert_allclose(
                np.asarray(mine(*coordinates), np.float64),
                np.asarray(theirs(*coordinates), np.float64), rtol=0, atol=1e-12)
    assert (problem.outer_solver is None) == (reference.outer_solver is None)
    if problem.outer_solver is not None:
        for key in ("type", "target_reduction", "max_iterations"):
            assert problem.outer_solver[key] == reference.outer_solver[key], key
        level = problem.max_level
        assert stencil_entries(
            problem.outer_solver["operator_factory"](level, problem.parameters),
            problem.grid_at(level)[0],
        ) == stencil_entries(
            reference.outer_solver["operator_factory"](level, reference.parameters),
            reference.grid_at(level)[0],
        )


@pytest.mark.parametrize("spec", SPEC_FILES)
def test_spec_parses_to_the_reference_problem(spec):
    reference, problem = both(os.path.join(SPECS, spec))
    assert_same_problem(reference, problem)
    # A Problem built from it has the same equations and operators per level.
    assert len(problem.equations) == len(reference.equations)
    assert [(o.name, o.level) for o in problem.operators] == [
        (o.name, o.level) for o in reference.operators]


def test_spec_written_here_parses_alike_in_both_packages(tmp_path):
    spec = tmp_path / "anisotropic.exa2"
    spec.write_text(ANISOTROPIC_SPEC)
    (tmp_path / "anisotropic.knowledge").write_text(ANISOTROPIC_KNOWLEDGE)
    reference, problem = both(str(spec))
    assert_same_problem(reference, problem)
    assert (problem.min_level, problem.max_level, problem.constants) == (2, 4, {"eps": 0.25})
    grid = problem.grid_at(4)[0]
    generator = problem.operator_factories["Laplace"][0](4, problem.parameters)
    assert stencil_entries(generator, grid) == gallery.Poisson2D(0.25).generate_stencil(grid).entries
    x, y = problem.interior_coordinates(3)
    np.testing.assert_allclose(problem.rhs_functions[0](x, y), np.sin(np.pi * x) * y, atol=1e-12)
    # The dtype argument and the problem's default.
    assert problem.dtype == torch.float32
    assert load_problem_file(str(spec), dtype=torch.float64).dtype == torch.float64


def test_load_problem_file_finds_knowledge_and_refuses_unknown_extensions(tmp_path):
    # The FAS template's knowledge file is named without "_template".
    problem = load_problem_file(os.path.join(SPECS, "FAS_2D_Basic_template.exa4"))
    assert (problem.min_level, problem.max_level) == (6, 10)
    # Without a knowledge file the layer's default levels apply.
    bare = tmp_path / "bare.exa2"
    bare.write_text(ANISOTROPIC_SPEC)
    assert (load_problem_file(str(bare)).min_level, load_problem_file(str(bare)).max_level) == (5, 9)
    explicit = tmp_path / "levels.knowledge"
    explicit.write_text("minLevel = 3\nmaxLevel = 6\n")
    problem = load_problem_file(str(bare), str(explicit))
    assert (problem.min_level, problem.max_level) == (3, 6)
    for name in ("spec.exa1", "spec.txt", "spec"):
        with pytest.raises(ValueError):
            load_problem_file(name)


def test_poisson_spec_is_poisson_2d():
    problem = load_problem_file(os.path.join(SPECS, "2D_FD_Poisson_fromL2.exa2"))
    assert (problem.dimension, problem.min_level, problem.max_level) == (2, 5, 9)
    assert problem.field_names == ["u"]
    hand = poisson.poisson_2d(5, 9)
    for level in range(5, 10):
        grid = problem.grid_at(level)[0]
        parsed = stencil_entries(problem.operator_factories["Laplace"][0](level, {}), grid)
        assert parsed == stencil_entries(hand.operator_factories["A"][0](level, {}), grid)
    stencil = periodic.lift(problem.finest_operator().entries[0][0].generate_stencil()).as_constant()
    assert stencil.center_value() == 4.0 / 2.0**-18
    # The right-hand side is poisson_2d's to the bit, in float64 and float32.
    for dtype in (torch.float64, torch.float32):
        np.testing.assert_array_equal(problem.rhs_arrays(dtype)[0], hand.rhs_arrays(dtype)[0])


def test_elasticity_spec_is_linear_elasticity_2d():
    problem = load_problem_file(os.path.join(SPECS, "2D_FD_LinearElasticity_fromL2.exa2"))
    assert problem.field_names == ["u", "v"]
    assert (problem.min_level, problem.max_level) == (4, 8)
    assert problem.constants == {"lam_": 195.0, "mu": 130.0}
    hand = linear_elasticity_2d(4, 8)
    assert (hand.constants["lam"], hand.constants["mu"]) == (195.0, 130.0)
    grid = problem.grid_at(6)[0]
    for name in ("dxx", "dyy", "dxy", "Laplace"):
        parsed = problem.operator_factories[name][0](6, {}).generate_stencil(grid).entries
        assert parsed == hand.operator_factories[name][0](6, {}).generate_stencil(grid).entries
    # Four transfers, one per field and kind.
    kinds = sorted(kind.__name__ for _, kind in problem.operator_factories.values())
    assert kinds.count("Restriction") == 2 and kinds.count("Prolongation") == 2


def test_helmholtz_spec_is_helmholtz_2d():
    problem = load_problem_file(os.path.join(SPECS, "2D_FD_Helmholtz_fromL3.exa3"))
    assert problem.field_names == ["u"]
    assert (problem.min_level, problem.max_level) == (3, 7)
    assert problem.parameters == {"k": 80.0, "shift": complex(1.0, 0.5)}
    assert problem.dtype == torch.complex64
    assert problem.outer_solver["target_reduction"] == 1e-7
    assert problem.outer_solver["max_iterations"] == 10000
    assert (problem.residual_target, problem.iteration_limit) == (1e-7, 10000)
    grid = problem.grid_at(7)[0]
    m_stencil = periodic.lift(problem.finest_operator().entries[0][0].generate_stencil()).as_constant()
    reference_m = gallery.Helmholtz2D(80.0, complex(1.0, 0.5)).generate_stencil(grid)
    assert sorted(m_stencil.entries) == sorted(reference_m.entries)
    a_generator = problem.outer_solver["operator_factory"](7, problem.parameters)
    reference_a = gallery.Helmholtz2D(80.0, 1.0).generate_stencil(grid)
    assert sorted(a_generator.generate_stencil(grid).entries) == sorted(reference_a.entries)
    # The k-ladder reaches the parsed operators through the parameters.
    doubled = problem.with_parameters({"k": 160.0})
    a_160 = doubled.outer_solver["operator_factory"](7, doubled.parameters)
    assert a_160.generate_stencil(grid).center_value() == reference_a.center_value() - 3 * 80.0**2
    x, y = problem.interior_coordinates(5)
    np.testing.assert_allclose(
        problem.rhs_functions[0](x, y), helmholtz.dirac_pulse_rhs(x, y), atol=1e-12)


def test_fas_spec_is_fas_2d():
    problem = load_problem_file(os.path.join(SPECS, "FAS_2D_Basic_template.exa4"))
    assert problem.uses_fas
    assert (problem.min_level, problem.max_level) == (6, 10)
    assert problem.constants["gam"] == 20.0
    assert (problem.residual_target, problem.iteration_limit) == (1e-10, 300)
    generator = problem.operator_factories["A"][0](10, problem.parameters)
    hand = fas.fas_2d().operator_factories["A"][0](10, {"gamma": 20.0})
    u = torch.linspace(-1.0, 1.0, 7, dtype=torch.float64)
    torch.testing.assert_close(generator.nonlinear_term(u), hand.nonlinear_term(u),
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(generator.derivative_diag(u), hand.derivative_diag(u),
                               rtol=1e-12, atol=1e-12)
    grid = problem.grid_at(10)[0]
    assert sorted(generator.generate_stencil(grid).entries) == sorted(
        hand.generate_stencil(grid).entries)
    assert generator.linear_center(grid) == hand.linear_center(grid)
    field = torch.from_numpy(np.random.default_rng(5).standard_normal((15, 15)))
    torch.testing.assert_close(generator.apply(field, problem.grid_at(4)[0]),
                               hand.apply(field, problem.grid_at(4)[0]), rtol=1e-12, atol=1e-9)
    x, y = problem.interior_coordinates(6)
    np.testing.assert_allclose(problem.rhs_functions[0](x, y), fas._rhs(x, y), atol=1e-10)


def test_fas_jacobian_matches_reference_on_seeded_u():
    path = os.path.join(SPECS, "FAS_2D_Basic_template.exa4")
    reference = jax_parser.parse_exa4(path, dtype=jnp.float64)
    problem = parser.parse_exa4(path, dtype=torch.float64)
    u = np.random.default_rng(20260817).uniform(-2.0, 2.0, (31, 31))
    jax_generator = reference.operator_factories["A"][0](5, reference.parameters)
    generator = problem.operator_factories["A"][0](5, problem.parameters)
    for method in ("nonlinear_term", "derivative_diag"):
        expected = np.asarray(getattr(jax_generator, method)(jnp.asarray(u)))
        got = getattr(generator, method)(torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=0)
    # The nonlinear operator's linearisation at u = 0 and its apply.
    grid = problem.grid_at(5)[0]
    assert generator.generate_stencil(grid).entries == jax_generator.generate_stencil(
        reference.grid_at(5)[0]).entries
    expected = np.asarray(jax_generator.apply(jnp.asarray(u), reference.grid_at(5)[0]))
    got = generator.apply(torch.from_numpy(u), grid).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-9 * np.abs(expected).max())
