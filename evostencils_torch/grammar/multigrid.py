"""The multigrid grammar: typed productions over cycle state machines.

Semantics preserved 1:1 from the reference grammar
(upstream evostencils/grammar/multigrid.py:176-478) because evolved
solvers must reproduce reference convergence factors:

  * state types per depth d: S_d (smoothable state), C_d (correction /
    residual state), each with a guarded twin; x_d, A_d, B_d, R_d, P_{d+1},
    CGS_{d+1}, Partitioning, RelaxationFactorIndex, BlockShape, NewtonSteps;
  * depth-d coarse types alias depth-(d+1) fine types to splice levels;
  * productions: residual, smoothing (decoupled/collective/collective-block
    Jacobi; Picard/Newton for FAS), coarsening (restrict + start coarse
    cycle), update_with_coarse_grid_correction, correct_with_coarse_grid_solver;
  * guard discipline: the start terminal u_and_f is guarded and only
    correct_with_coarse_grid_solver discharges the guard, so every complete
    tree contains a coarsest-grid solve;
  * relaxation factors come from np.linspace(0.1, 1.9, 37) by index.

Derivation attribution: the production *semantics* implemented by the
state-transition functions in ``add_level`` (the residual/update/
initiate-cycle/coarse-grid-correction state machine, including the FAS
τ-correction construction) are derived from EvoStencils
(https://github.com/jonas-schmitt/evostencils, © Jonas Schmitt,
AGPL-3.0; evostencils/grammar/multigrid.py:238-385).  A multigrid cycle
grammar admits few distinct spellings of these transitions, so this
module — unlike the rest of this repository, which is an independent
TPU-native design — should be treated as a derivative work of that
grammar and is provided under the terms of the AGPL-3.0 (see NOTICE at
the repository root).  The surrounding machinery (TypeUniverse,
PrimitiveSet registration, typed-GP engine) is original.
"""

from __future__ import annotations

import itertools
from functools import reduce
from typing import List

import numpy as np
import sympy

from evostencils_torch.grammar.gp import PrimitiveSet
from evostencils_torch.grammar.typing import Type
from evostencils_torch.ir import base, smoother, system
from evostencils_torch.ir import partitioning as part


class OperatorInfo:
    """Named operator on a level with its stencil generator
    (reference multigrid.py:15-37)."""

    def __init__(self, name, level, stencil_generator, operator_type=base.Operator):
        self.name = name
        self.level = level
        self.stencil_generator = stencil_generator
        self.operator_type = operator_type
        self.associated_field = None

    @property
    def stencil(self):
        return self.stencil_generator


class EquationInfo:
    """One PDE equation 'lhs == rhs_name' with sympy lhs
    (reference multigrid.py:40-71)."""

    def __init__(self, name: str, level: int, expr_str: str):
        self.name = name
        self.level = level
        stripped = " ".join(tok.split("@")[0] for tok in expr_str.split(" "))
        lhs, rhs = stripped.split("==")
        self.sympy_expr = sympy.parsing.sympy_parser.parse_expr(lhs)
        self.rhs_name = rhs.strip()
        self.associated_field = None


def generate_operator_entries_from_equation(equation, operators: list, fields, grid):
    """sympy expand/collect the equation lhs into a block row of IR operators
    (reference multigrid.py:74-119)."""
    row = []
    indices = []

    def descend(expr, field_index):
        if expr.is_Number:
            identity = base.Identity(grid[field_index])
            if expr == sympy.sympify(1):
                return identity
            return base.Scaling(float(expr.evalf()), identity)
        if expr.is_Symbol:
            info = next(op for op in operators if op.name == expr.name)
            return base.Operator(
                expr.name, grid[field_index], _as_generator(info.stencil_generator)
            )
        if expr.is_Mul:
            acc = descend(expr.args[-1], field_index)
            for arg in expr.args[-2::-1]:
                if arg.is_Number:
                    acc = base.Scaling(float(arg.evalf()), acc)
                else:
                    acc = base.Multiplication(descend(arg, field_index), acc)
            return acc
        if expr.is_Add:
            acc = descend(expr.args[0], field_index)
            for arg in expr.args[1:]:
                acc = base.Addition(descend(arg, field_index), acc)
            return acc
        raise RuntimeError(f"Invalid expression in equation: {expr}")

    expanded = sympy.expand(equation.sympy_expr)
    for i, field in enumerate(fields):
        if field in expanded.free_symbols:
            term = sympy.collect(expanded, field, evaluate=False)[field]
            row.append(descend(term, i))
            indices.append(i)
    for i in range(len(grid)):
        if i not in indices:
            row.append(base.ZeroOperator(grid[i]))
            indices.append(i)
    return [op for _, op in sorted(zip(indices, row), key=lambda p: p[0])]


def _as_generator(stencil_or_generator):
    if hasattr(stencil_or_generator, "generate_stencil"):
        return stencil_or_generator
    return base.ConstantStencilGenerator(stencil_or_generator)


def generate_system_operator(equations, operators, fields, level, depth, grid):
    """Block operator A_depth for one level (reference multigrid.py:122-137)."""
    ops_on_level = [
        op
        for op in operators
        if op.level == level
        and op.operator_type not in (base.Restriction, base.Prolongation)
    ]
    eqs_on_level = [eq for eq in equations if eq.level == level]
    entries = [
        generate_operator_entries_from_equation(eq, ops_on_level, fields, grid)
        for eq in eqs_on_level
    ]
    return system.Operator(f"A_{depth}", entries)


def generate_operators_on_level(
    equations, operators, fields, level, depth, fine_grid, coarse_grid
):
    """(A, R, P) for one level (reference multigrid.py:140-173)."""
    ops_on_level = [op for op in operators if op.level == level]
    restrictions, prolongations, system_ops = [], [], []
    for op in ops_on_level:
        if op.operator_type == base.Restriction:
            if "restrictionForSol" not in op.name and "restriction_sol" not in op.name:
                restrictions.append(op)
        elif op.operator_type == base.Prolongation:
            prolongations.append(op)
        else:
            system_ops.append(op)
    if len(restrictions) != len(fields):
        raise ValueError("Number of restriction operators must match fields")
    if len(prolongations) != len(fields):
        raise ValueError("Number of prolongation operators must match fields")
    restriction = system.Restriction(
        f"R_{depth}",
        [
            base.Restriction(op.name, fine_grid[i], coarse_grid[i], _as_generator(op.stencil_generator))
            for i, op in enumerate(restrictions)
        ],
    )
    prolongation = system.Prolongation(
        f"P_{depth + 1}",
        [
            base.Prolongation(op.name, fine_grid[i], coarse_grid[i], _as_generator(op.stencil_generator))
            for i, op in enumerate(prolongations)
        ],
    )
    eqs_on_level = [eq for eq in equations if eq.level == level]
    entries = [
        generate_operator_entries_from_equation(eq, system_ops, fields, fine_grid)
        for eq in eqs_on_level
    ]
    operator = system.Operator(f"A_{depth}", entries)
    return operator, restriction, prolongation


class Terminals:
    """Per-level bundle of grammar terminals (reference multigrid.py:176-194)."""

    def __init__(
        self,
        approximation,
        operator,
        coarse_operator,
        restriction_operators,
        prolongation_operators,
        coarse_grid_solver,
        relaxation_factor_interval,
        partitionings=None,
    ):
        self.approximation = approximation
        self.operator = operator
        self.coarse_operator = coarse_operator
        self.restriction_operators = restriction_operators
        self.prolongation_operators = prolongation_operators
        self.coarse_grid_solver = coarse_grid_solver
        self.relaxation_factor_interval = relaxation_factor_interval
        self.no_partitioning = part.Single
        self.partitionings = partitionings or []

    @property
    def grid(self):
        return self.operator.grid

    @property
    def coarse_grid(self):
        return self.coarse_operator.grid

    # Convenience accessors used by reference cycle construction / tests.
    @property
    def restriction(self):
        return self.restriction_operators[0]

    @property
    def prolongation(self):
        return self.prolongation_operators[0]

    @property
    def red_black_partitioning(self):
        return part.RedBlack


class TypeUniverse:
    """Per-depth grammar types; coarse types of depth d alias fine types of
    depth d+1 (reference multigrid.py:196-235)."""

    def __init__(self, depth: int, previous: "TypeUniverse | None" = None, FAS: bool = False):
        def fine(tag, coarse_attr, guard=False):
            if previous is None:
                return Type(f"{tag}_{depth}", guard)
            return getattr(previous, coarse_attr)

        self.S_h = fine("S", "S_2h")
        self.S_guard_h = fine("S_guard", "S_guard_2h", guard=True)
        self.C_h = fine("C", "C_2h")
        self.C_guard_h = fine("C_guard", "C_guard_2h", guard=True)
        self.x_h = fine("x", "x_2h")
        self.A_h = fine("A", "A_2h")
        self.B_h = fine("B", "B_2h")
        self.R_h = Type(f"R_{depth}")

        c = depth + 1
        self.S_2h = Type(f"S_{c}")
        self.S_guard_2h = Type(f"S_guard_{c}", guard=True)
        self.C_2h = Type(f"C_{c}")
        self.C_guard_2h = Type(f"C_guard_{c}", guard=True)
        self.x_2h = Type(f"x_{c}")
        self.A_2h = Type(f"A_{c}")
        self.B_2h = Type(f"B_{c}")
        self.P_2h = Type(f"P_{c}")
        self.CGS_2h = Type(f"CGC_{c}")

        def shared(tag):
            if previous is None:
                return Type(tag)
            return getattr(previous, tag)

        self.Partitioning = shared("Partitioning")
        self.RelaxationFactorIndex = shared("RelaxationFactorIndex")
        self.BlockShape = shared("BlockShape")
        if FAS:
            self.NewtonSteps = shared("NewtonSteps")


def add_level(pset: PrimitiveSet, terminals: Terminals, types: TypeUniverse, depth: int,
              coarsest: bool = False, FAS: bool = False):
    """Register one level's terminals and state-transition productions
    (reference multigrid.py:238-385)."""
    if not coarsest:
        pset.add_terminal(
            system.ZeroApproximation(terminals.coarse_grid), types.x_2h, f"zero_{depth + 1}"
        )
        pset.add_terminal(terminals.coarse_operator, types.A_2h, f"A_{depth + 1}")
    for prolongation in terminals.prolongation_operators:
        pset.add_terminal(prolongation, types.P_2h, f"{prolongation.name}")
    for restriction in terminals.restriction_operators:
        pset.add_terminal(restriction, types.R_h, f"{restriction.name}")

    scalar_equation = len(terminals.grid) == 1

    # ---- state transitions (each returns IR, built exactly as the
    # reference's closures do) ----

    def residual(state):
        approximation, rhs = state
        return base.Cycle(
            approximation,
            rhs,
            base.Residual(terminals.operator, approximation, rhs),
            predecessor=approximation.predecessor,
        )

    def apply_op(operator, cycle):
        cycle.correction = base.Multiplication(operator, cycle.correction)
        return cycle

    def update(relaxation_factor_index, partitioning_, cycle):
        cycle.relaxation_factor = terminals.relaxation_factor_interval[
            relaxation_factor_index
        ]
        cycle.partitioning = partitioning_
        return cycle, cycle.rhs

    def initiate_cycle(coarse_operator, coarse_approximation, cycle):
        coarse_residual = base.Residual(
            coarse_operator, coarse_approximation, cycle.correction
        )
        new_cycle = base.Cycle(coarse_approximation, cycle.correction, coarse_residual)
        new_cycle.predecessor = cycle
        return new_cycle

    def coarse_grid_correction(prolongation_operator, state, restriction_operator=None):
        cycle = state[0]
        if FAS:
            correction_fas = base.mul(
                restriction_operator, cycle.predecessor.approximation
            )
            correction = base.mul(
                prolongation_operator, base.sub(cycle, correction_fas)
            )
        else:
            correction = base.Multiplication(prolongation_operator, cycle)
        cycle.predecessor.correction = correction
        return cycle.predecessor

    def restrict(restriction_operator, cycle):
        if FAS:
            residual_c = base.mul(restriction_operator, cycle.correction)
            residual_fas = base.mul(
                terminals.coarse_operator,
                base.Multiplication(restriction_operator, cycle.approximation),
            )
            cycle.correction = base.add(residual_c, residual_fas)
            return cycle
        return apply_op(restriction_operator, cycle)

    def coarsening(coarse_operator, coarse_approximation, restriction_operator, cycle):
        cycle = restrict(restriction_operator, cycle)
        return initiate_cycle(coarse_operator, coarse_approximation, cycle)

    def update_with_coarse_grid_correction(
        relaxation_factor_index, prolongation_operator, state, restriction_operator=None
    ):
        cycle = coarse_grid_correction(prolongation_operator, state, restriction_operator)
        return update(relaxation_factor_index, terminals.no_partitioning, cycle)

    def smoothing(relaxation_factor_index, partitioning_, generate_smoother, cycle):
        assert isinstance(cycle.correction, base.Residual), "expected residual state"
        smoothing_operator = generate_smoother(cycle.correction.operator)
        cycle = apply_op(base.Inverse(smoothing_operator), cycle)
        return update(relaxation_factor_index, partitioning_, cycle)

    def decoupled_jacobi(relaxation_factor_index, partitioning_, cycle):
        return smoothing(
            relaxation_factor_index, partitioning_, smoother.generate_decoupled_jacobi, cycle
        )

    def collective_jacobi(relaxation_factor_index, partitioning_, cycle):
        return smoothing(
            relaxation_factor_index, partitioning_, smoother.generate_collective_jacobi, cycle
        )

    def collective_block_jacobi(relaxation_factor_index, block_shape, cycle):
        return smoothing(
            relaxation_factor_index,
            part.Single,
            lambda op: smoother.generate_collective_block_jacobi(op, block_shape),
            cycle,
        )

    def jacobi_picard(relaxation_factor_index, partitioning_, cycle):
        return smoothing(
            relaxation_factor_index, partitioning_, smoother.generate_jacobi_picard, cycle
        )

    def jacobi_newton(relaxation_factor_index, partitioning_, n_newton_steps, cycle):
        return smoothing(
            relaxation_factor_index,
            partitioning_,
            lambda op: smoother.generate_jacobi_newton(op, n_newton_steps),
            cycle,
        )

    def correct_with_coarse_grid_solver(
        relaxation_factor_index, prolongation_operator, coarse_grid_solver,
        restriction_operator, cycle,
    ):
        cycle = restrict(restriction_operator, cycle)
        if FAS:
            approximation_c = base.mul(coarse_grid_solver, cycle.correction)
            restricted_solution_fas = base.mul(restriction_operator, cycle.approximation)
            cycle.correction = base.mul(
                prolongation_operator,
                base.sub(approximation_c, restricted_solution_fas),
            )
        else:
            cycle = apply_op(prolongation_operator, apply_op(coarse_grid_solver, cycle))
        return update(relaxation_factor_index, terminals.no_partitioning, cycle)

    def add_guarded_pair(fn, fixed_types, in_types, out_types, name):
        for t_in, t_out in zip(in_types, out_types):
            pset.add_primitive(fn, list(fixed_types) + [t_in], t_out, name)

    # ---- production registration (reference multigrid.py:349-385) ----
    add_guarded_pair(
        residual, [], [types.S_h, types.S_guard_h], [types.C_h, types.C_guard_h],
        f"residual_{depth}",
    )
    if not scalar_equation:
        add_guarded_pair(
            decoupled_jacobi,
            [types.RelaxationFactorIndex, types.Partitioning],
            [types.C_h, types.C_guard_h],
            [types.S_h, types.S_guard_h],
            f"decoupled_jacobi_{depth}",
        )
    if not FAS:
        add_guarded_pair(
            collective_jacobi,
            [types.RelaxationFactorIndex, types.Partitioning],
            [types.C_h, types.C_guard_h],
            [types.S_h, types.S_guard_h],
            f"collective_jacobi_{depth}",
        )
        add_guarded_pair(
            collective_block_jacobi,
            [types.RelaxationFactorIndex, types.BlockShape],
            [types.C_h, types.C_guard_h],
            [types.S_h, types.S_guard_h],
            f"collective_block_jacobi_{depth}",
        )
    else:
        add_guarded_pair(
            jacobi_picard,
            [types.RelaxationFactorIndex, types.Partitioning],
            [types.C_h, types.C_guard_h],
            [types.S_h, types.S_guard_h],
            f"jacobi_picard_{depth}",
        )
        add_guarded_pair(
            jacobi_newton,
            [types.RelaxationFactorIndex, types.Partitioning, types.NewtonSteps],
            [types.C_h, types.C_guard_h],
            [types.S_h, types.S_guard_h],
            f"jacobi_newton_{depth}",
        )

    if not coarsest:
        if FAS:
            # FAS needs the restriction operator as an extra trailing
            # argument (to form the τ-correction); reference multigrid.py:368-375.
            for t_in, t_out in (
                (types.S_2h, types.S_h),
                (types.S_guard_2h, types.S_guard_h),
            ):
                pset.add_primitive(
                    update_with_coarse_grid_correction,
                    [types.RelaxationFactorIndex, types.P_2h, t_in, types.R_h],
                    t_out,
                    f"update_with_coarse_grid_correction_{depth}",
                )
        else:
            add_guarded_pair(
                update_with_coarse_grid_correction,
                [types.RelaxationFactorIndex, types.P_2h],
                [types.S_2h, types.S_guard_2h],
                [types.S_h, types.S_guard_h],
                f"update_with_coarse_grid_correction_{depth}",
            )
        add_guarded_pair(
            coarsening,
            [types.A_2h, types.x_2h, types.R_h],
            [types.C_h, types.C_guard_h],
            [types.C_2h, types.C_guard_2h],
            f"coarsening_{depth}",
        )
    else:
        add_guarded_pair(
            correct_with_coarse_grid_solver,
            [types.RelaxationFactorIndex, types.P_2h, types.CGS_2h, types.R_h],
            [types.C_h, types.C_guard_h],
            [types.S_h, types.S_h],  # guard discharged here (both map to S_h)
            f"correct_with_coarse_grid_solver_{depth}",
        )
        pset.add_terminal(
            terminals.coarse_grid_solver, types.CGS_2h, f"CGS_{depth + 1}"
        )


def add_block_shapes(pset, fields, approximation, types, dimension, maximum_local_system_size):
    """Enumerate per-field block-shape tuples with total size in
    (n_fields, maximum_local_system_size] (reference multigrid.py:388-407)."""
    per_field_shapes = []
    for _ in fields:
        shapes = list(
            itertools.product(range(1, maximum_local_system_size + 1), repeat=dimension)
        )
        per_field_shapes.append(shapes)
    for permutation in itertools.product(*per_field_shapes):
        total = sum(reduce(lambda x, y: x * y, shape) for shape in permutation)
        if len(approximation.grid) < total <= maximum_local_system_size:
            name = "bs_" + "_".join("x".join(str(s) for s in shape) for shape in permutation)
            pset.add_terminal(permutation, types.BlockShape, name)


def generate_primitive_set(
    approximation,
    rhs,
    dimension,
    coarsening_factors,
    max_level,
    equations: List[EquationInfo],
    operators: List[OperatorInfo],
    fields,
    maximum_local_system_size=8,
    relaxation_factor_samples=37,
    coarse_grid_solver_expression=None,
    depth=2,
    enable_partitioning=True,
    FAS=False,
):
    """Build the typed primitive set over `depth` levels
    (reference multigrid.py:409-478)."""
    assert depth >= 1, "depth must be positive"
    coarsest = depth == 1
    fine_grid = approximation.grid
    coarse_grid = system.get_coarse_grid(fine_grid, coarsening_factors)
    operator, restriction, prolongation = generate_operators_on_level(
        equations, operators, fields, max_level, 0, fine_grid, coarse_grid
    )
    coarse_operator, coarse_restriction, coarse_prolongation = generate_operators_on_level(
        equations, operators, fields, max_level - 1, 1, coarse_grid,
        system.get_coarse_grid(coarse_grid, coarsening_factors),
    )
    partitionings = [part.RedBlack]
    restriction_operators = [restriction]
    prolongation_operators = [prolongation]
    coarse_grid_solver = base.CoarseGridSolver(
        "CGS", coarse_operator, coarse_grid_solver_expression
    )
    relaxation_factor_interval = np.linspace(0.1, 1.9, relaxation_factor_samples)
    terminals = Terminals(
        approximation, operator, coarse_operator, restriction_operators,
        prolongation_operators, coarse_grid_solver, relaxation_factor_interval,
        partitionings,
    )
    types = TypeUniverse(0, FAS=FAS)
    pset = PrimitiveSet("main", types.S_h)
    pset.add_terminal((approximation, rhs), types.S_guard_h, "u_and_f")
    pset.add_terminal(terminals.no_partitioning, types.Partitioning, part.Single.get_name())
    if enable_partitioning:
        for p in terminals.partitionings:
            pset.add_terminal(p, types.Partitioning, p.get_name())
    for i in range(relaxation_factor_samples):
        pset.add_terminal(i, types.RelaxationFactorIndex, f"rf_{i}")
    if not FAS:
        add_block_shapes(pset, fields, approximation, types, dimension, maximum_local_system_size)
    if FAS:
        for i in (1, 2, 3, 4):
            pset.add_terminal(i, types.NewtonSteps, f"newton_{i}")

    add_level(pset, terminals, types, 0, coarsest=coarsest, FAS=FAS)

    terminal_list = [terminals]
    for i in range(1, depth):
        approximation = system.ZeroApproximation(terminals.coarse_grid)
        operator = coarse_operator
        prolongation_operators = [coarse_prolongation]
        restriction_operators = [coarse_restriction]
        fine_grid = terminals.coarse_grid
        coarse_grid = system.get_coarse_grid(fine_grid, coarsening_factors)
        coarsest = i == depth - 1
        if coarsest:
            coarse_operator = generate_system_operator(
                equations, operators, fields, max_level - i - 1, i + 1, coarse_grid
            )
        else:
            coarse_operator, coarse_restriction, coarse_prolongation = (
                generate_operators_on_level(
                    equations, operators, fields, max_level - i - 1, i + 1,
                    coarse_grid, system.get_coarse_grid(coarse_grid, coarsening_factors),
                )
            )
        coarse_grid_solver = base.CoarseGridSolver(
            "CGS", coarse_operator, coarse_grid_solver_expression
        )
        terminals = Terminals(
            approximation, operator, coarse_operator, restriction_operators,
            prolongation_operators, coarse_grid_solver, relaxation_factor_interval,
            partitionings,
        )
        types = TypeUniverse(i, previous=types, FAS=FAS)
        add_level(pset, terminals, types, i, coarsest=coarsest, FAS=FAS)
        terminal_list.append(terminals)

    return pset, terminal_list


def textbook_cycle_string(
    terminal_list,
    pre_smoothing=2,
    post_smoothing=1,
    omega_index=18,
    cgc_omega_index=18,
    partitioning_name="red_black",
    smoother_name="collective_jacobi",
    FAS=False,
) -> str:
    """Grammar STRING of the textbook V(pre, post) cycle over the full
    hierarchy — the derivation the grammar itself would need to discover.

    Used to SEED evolutionary runs with known-good shapes (the reference's
    Helmholtz result started from huge random populations on an MPI
    cluster, μ=λ=128×150, reference optimization/program.py:770; seeding
    recovers that head start at single-chip budgets).  `omega_index`
    indexes the rf_i grid np.linspace(0.1, 1.9, 37): ω = 0.1 + 0.05·i.

    With ``FAS=True`` the string targets the nonlinear grammar: the
    default smoother becomes ``jacobi_picard`` (same arity as
    collective_jacobi) and ``update_with_coarse_grid_correction`` gains
    the trailing restriction operator the FAS τ-correction requires
    (reference grammar/multigrid.py:368-375).
    """
    if FAS and smoother_name == "collective_jacobi":
        smoother_name = "jacobi_picard"
    depth = len(terminal_list)
    # jacobi_newton takes an extra NewtonSteps terminal between the
    # partitioning and the state (grammar registration above).
    smoother_extra = ",newton_2" if smoother_name == "jacobi_newton" else ""

    def rec(d, state, is_correction_state):
        t = terminal_list[d]
        p_name = t.prolongation_operators[0].name
        r_name = t.restriction_operators[0].name
        c_state = is_correction_state
        for _ in range(pre_smoothing):
            if not c_state:
                state = f"residual_{d}({state})"
            state = (
                f"{smoother_name}_{d}(rf_{omega_index},{partitioning_name}"
                f"{smoother_extra},{state})"
            )
            c_state = False
        if not c_state:
            state = f"residual_{d}({state})"
        if d == depth - 1:
            state = (
                f"correct_with_coarse_grid_solver_{d}(rf_{cgc_omega_index},"
                f"{p_name},CGS_{d + 1},{r_name},{state})"
            )
        else:
            coarse = f"coarsening_{d}(A_{d + 1},zero_{d + 1},{r_name},{state})"
            coarse_solved = rec(d + 1, coarse, True)
            fas_tail = f",{r_name}" if FAS else ""
            state = (
                f"update_with_coarse_grid_correction_{d}(rf_{cgc_omega_index},"
                f"{p_name},{coarse_solved}{fas_tail})"
            )
        for _ in range(post_smoothing):
            state = (
                f"{smoother_name}_{d}(rf_{omega_index},{partitioning_name}"
                f"{smoother_extra},residual_{d}({state}))"
            )
        return state

    return rec(0, "u_and_f", False)
