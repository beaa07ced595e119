"""Block (system-of-PDEs) IR: lifts the scalar IR to block matrices/vectors.

Parity with upstream evostencils/ir/system.py:5-158.  A system
Operator is a 2-D list of scalar operator expressions; Approximation /
RightHandSide are lists of per-field grid functions; intergrid operators
are block-diagonal per field.  The smoother markers Diagonal /
ElementwiseDiagonal / Jacobian select how `Inverse` is lowered by the
backend (decoupled point-Jacobi, collective per-point solve, or FAS
Newton smoothing respectively).
"""

from __future__ import annotations

from typing import List, Tuple

from evostencils_torch.ir import base


class System(base.Expression):
    def __init__(self, name, entries, shape):
        self._name = name
        self._entries = entries
        self._shape = shape
        super().__init__()

    @property
    def name(self):
        return self._name

    @property
    def entries(self):
        return self._entries

    @property
    def shape(self):
        return self._shape

    def apply(self, _, *args):
        return self

    def mutate(self, _, *args):
        pass


class Operator(System):
    def __init__(self, name, entries):
        rows = sum(row[0].shape[0] for row in entries)
        cols = sum(entry.shape[1] for entry in entries[0])
        super().__init__(name, entries, (rows, cols))

    @property
    def grid(self):
        return [entry.grid for entry in self.entries[0]]

    def __str__(self):
        return self.name


class ZeroOperator(Operator):
    def __init__(self, grid: List[base.Grid], name="0"):
        entries = [[base.ZeroOperator(g) for g in grid] for _ in grid]
        super().__init__(name, entries)


class Identity(Operator):
    def __init__(self, grid: List[base.Grid], name="I"):
        entries = [
            [base.Identity(g) if i == j else base.ZeroOperator(g) for j, g in enumerate(grid)]
            for i, _ in enumerate(grid)
        ]
        super().__init__(name, entries)


class Approximation(System):
    def __init__(self, name, entries):
        if len(entries) == 1:
            shape = entries[0].shape
        else:
            shape = (sum(e.shape[0] for e in entries), entries[0].shape[1])
        super().__init__(name, entries, shape)

    @property
    def grid(self):
        return [entry.grid for entry in self.entries]

    @property
    def predecessor(self):
        return None

    def __str__(self):
        return self.name


class RightHandSide(Approximation):
    pass


class ZeroApproximation(Approximation):
    def __init__(self, grid: List[base.Grid], name="0"):
        super().__init__(name, [base.ZeroApproximation(g) for g in grid])


class InterGridOperator(Operator):
    def __init__(self, name, list_of_intergrid_operators, zero_operator_type):
        entries = [
            [
                op
                if i == j
                else zero_operator_type(op.fine_grid, op.coarse_grid)
                for j in range(len(list_of_intergrid_operators))
            ]
            for i, op in enumerate(list_of_intergrid_operators)
        ]
        super().__init__(name, entries)


class Restriction(InterGridOperator):
    def __init__(self, name, list_of_intergrid_operators):
        super().__init__(name, list_of_intergrid_operators, base.ZeroRestriction)


class Prolongation(InterGridOperator):
    def __init__(self, name, list_of_intergrid_operators):
        super().__init__(name, list_of_intergrid_operators, base.ZeroProlongation)


class Diagonal(base.UnaryExpression):
    """Decoupled point smoother: block-diagonal of per-field diagonals."""

    def __str__(self):
        return f"{self.operand}.diag"


class ElementwiseDiagonal(base.UnaryExpression):
    """Collective point smoother: per-gridpoint solve coupling all fields."""

    def __str__(self):
        return "D"


class Jacobian(base.UnaryExpression):
    """FAS Newton smoother marker carrying the Newton step count."""

    def __init__(self, operand, n_newton_steps):
        self.n_newton_steps = n_newton_steps
        super().__init__(operand)

    def apply(self, transform: callable, *args):
        return Jacobian(transform(self.operand, *args), self.n_newton_steps)

    def __str__(self):
        return f"J[{self.n_newton_steps}]"


def get_coarse_grid(grid: List[base.Grid], coarsening_factors: List[Tuple[int, ...]]):
    return [base.get_coarse_grid(g, cf) for g, cf in zip(grid, coarsening_factors)]


def get_coarse_approximation(approximation: Approximation, coarsening_factors):
    return Approximation(
        f"{approximation.name}",
        [
            base.Approximation(f"{entry.name}_c", base.get_coarse_grid(entry.grid, cf))
            for entry, cf in zip(approximation.entries, coarsening_factors)
        ],
    )


def get_coarse_rhs(rhs: RightHandSide, coarsening_factors):
    return RightHandSide(
        f"{rhs.name}",
        [
            base.RightHandSide(f"{entry.name}_c", base.get_coarse_grid(entry.grid, cf))
            for entry, cf in zip(rhs.entries, coarsening_factors)
        ],
    )


def get_coarse_operator(operator, coarse_grid):
    new_entries = [
        [base.Operator(f"{entry.name}_c", coarse_grid[i], entry.stencil_generator) for entry in row]
        for i, row in enumerate(operator.entries)
    ]
    return Operator(f"{operator.name}", new_entries)
