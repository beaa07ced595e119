"""Matrix-free expression IR for multigrid cycles (scalar equations).

Node taxonomy keeps parity with upstream evostencils/ir/base.py:122-697
(Operator / Identity / ZeroOperator / Grid / Approximation / RightHandSide /
ZeroApproximation / Diagonal / LowerTriangle / UpperTriangle / BlockDiagonal /
Inverse / Transpose / Addition / Subtraction / Multiplication / Scaling /
Restriction / Prolongation / CoarseGridSolver / Residual / Cycle) because the
grammar's production rules and both analysis backends are defined against
exactly this vocabulary.  The implementation is new: nodes carry generic
analysis caches in a dict (`analysis_cache`) instead of hard-coded
lfa_symbol/runtime slots, and every node exposes `cache_key()` so that
structurally identical cycles hash to the same XLA compilation-cache entry.
"""

from __future__ import annotations

import abc
from functools import reduce
import operator as _op

from evostencils_torch.ir import partitioning as part
from evostencils_torch.stencils import constant, periodic


class Expression(abc.ABC):
    """Base class of all IR nodes."""

    def __init__(self):
        # Memoization slots shared by analysis passes (LFA symbols, roofline
        # runtimes).  Keyed per pass; invalidated via transformations.invalidate.
        self.analysis_cache = {}

    @property
    @abc.abstractmethod
    def shape(self):
        ...

    @property
    @abc.abstractmethod
    def grid(self):
        ...

    @abc.abstractmethod
    def apply(self, transform: callable, *args):
        """Rebuild this node with transformed children."""

    @abc.abstractmethod
    def mutate(self, f: callable, *args):
        """Visit children in place."""


class Entity(Expression):
    """Leaf node: named object living on a grid."""

    def __init__(self, name, grid, shape):
        self._name = name
        self._grid = grid
        self._shape = shape
        super().__init__()

    @property
    def name(self):
        return self._name

    @property
    def grid(self):
        return self._grid

    @property
    def shape(self):
        return self._shape

    def apply(self, _, *args):
        return self

    def mutate(self, _, *args):
        pass

    def __str__(self):
        return f"{self.name}"


class UnaryExpression(Expression):
    def __init__(self, operand):
        self._operand = operand
        self._shape = operand.shape
        super().__init__()

    @property
    def operand(self):
        return self._operand

    @property
    def shape(self):
        return self._shape

    @property
    def grid(self):
        return self.operand.grid

    def apply(self, transform: callable, *args):
        return type(self)(transform(self.operand, *args))

    def mutate(self, f: callable, *args):
        f(self.operand, *args)


class BinaryExpression(Expression):
    def __init__(self, operand1, operand2):
        self._operand1 = operand1
        self._operand2 = operand2
        super().__init__()

    @property
    def operand1(self):
        return self._operand1

    @property
    def operand2(self):
        return self._operand2

    @property
    def shape(self):
        raise NotImplementedError("Shape undefined for generic binary expression")

    @property
    def grid(self):
        return self.operand1.grid

    def apply(self, transform: callable, *args):
        return type(self)(transform(self.operand1, *args), transform(self.operand2, *args))

    def mutate(self, f: callable, *args):
        f(self.operand1, *args)
        f(self.operand2, *args)


class Grid:
    """Structured grid: size per axis (number of cells = 2^level), spacing, level."""

    __slots__ = ("_size", "_spacing", "_level")

    def __init__(self, size, spacing, level):
        assert len(size) == len(spacing), "size/spacing dimensions must match"
        self._size = tuple(size)
        self._spacing = tuple(spacing)
        self._level = level

    @property
    def size(self):
        return self._size

    @property
    def spacing(self):
        return self._spacing

    @property
    def level(self):
        return self._level

    @property
    def dimension(self):
        return len(self._size)

    @property
    def interior_shape(self):
        """Number of interior (unknown) nodes per axis for Dirichlet problems."""
        return tuple(n - 1 for n in self._size)

    def __eq__(self, other):
        return (
            isinstance(other, Grid)
            and self.size == other.size
            and self.spacing == other.spacing
        )

    def __hash__(self):
        return hash((self._size, self._spacing))

    def __repr__(self):
        return f"Grid({self._size!r}, {self._spacing!r}, {self._level!r})"


class Operator(Entity):
    """Linear operator defined by a stencil generator on a grid."""

    def __init__(self, name, grid, stencil_generator=None):
        n = reduce(_op.mul, grid.size)
        self._stencil_generator = stencil_generator
        super().__init__(name, grid, (n, n))

    @property
    def stencil_generator(self):
        return self._stencil_generator

    def generate_stencil(self):
        if self._stencil_generator is None:
            return None
        return self._stencil_generator.generate_stencil(self._grid)

    def __repr__(self):
        return f"Operator({self.name!r}, {self.grid!r}, {self._stencil_generator!r})"


class Identity(Operator):
    def __init__(self, grid, name="I"):
        from evostencils_torch.stencils.gallery import IdentityGenerator

        super().__init__(name, grid, IdentityGenerator(grid.dimension))

    def __repr__(self):
        return f"Identity({self.grid!r})"


class ZeroOperator(Operator):
    def __init__(self, grid, shape=None, name="0"):
        from evostencils_torch.stencils.gallery import ZeroGenerator

        super().__init__(name, grid, ZeroGenerator(grid.dimension))
        if shape is not None:
            self._shape = shape

    def __repr__(self):
        return f"ZeroOperator({self.grid!r})"


class Approximation(Entity):
    """Grid function (vector of unknowns)."""

    def __init__(self, name, grid):
        shape = (reduce(_op.mul, grid.size), 1)
        super().__init__(name, grid, shape)

    @property
    def predecessor(self):
        return None

    def generate_stencil(self):
        return constant.get_unit_stencil(self.grid)

    def __eq__(self, other):
        return (
            isinstance(other, Approximation)
            and self.name == other.name
            and self.grid == other.grid
        )

    def __hash__(self):
        return hash((type(self).__name__, self.name, self.grid))

    def __repr__(self):
        return f"Approximation({self.name!r}, {self.grid!r})"


class RightHandSide(Approximation):
    def generate_stencil(self):
        return constant.get_null_stencil(self.grid)

    def __repr__(self):
        return f"RightHandSide({self.name!r}, {self.grid!r})"


class ZeroApproximation(Approximation):
    def __init__(self, grid, name="0"):
        super().__init__(name, grid)

    def generate_stencil(self):
        return constant.get_null_stencil(self.grid)

    def __repr__(self):
        return f"ZeroApproximation({self.grid!r})"


# --- Unary operator expressions -------------------------------------------


class Diagonal(UnaryExpression):
    def generate_stencil(self):
        return periodic.diagonal(self.operand.generate_stencil())

    def __str__(self):
        return f"{self.operand}.diag"


class LowerTriangle(UnaryExpression):
    def generate_stencil(self):
        return periodic.lower(self.operand.generate_stencil())

    def __str__(self):
        return f"{self.operand}.lower"


class UpperTriangle(UnaryExpression):
    def generate_stencil(self):
        return periodic.upper(self.operand.generate_stencil())

    def __str__(self):
        return f"{self.operand}.upper"


class BlockDiagonal(UnaryExpression):
    def __init__(self, operand, block_size):
        self._block_size = tuple(block_size)
        super().__init__(operand)

    @property
    def block_size(self):
        return self._block_size

    def generate_stencil(self):
        return periodic.block_diagonal(self.operand.generate_stencil(), self.block_size)

    def apply(self, transform: callable, *args):
        return BlockDiagonal(transform(self.operand, *args), self.block_size)

    def __str__(self):
        return f"{self.operand}.block_diag{self.block_size}"


class Inverse(UnaryExpression):
    def generate_stencil(self):
        return periodic.inverse(self.operand.generate_stencil())

    def __str__(self):
        return f"{self.operand}.I"


class Transpose(UnaryExpression):
    def __init__(self, operand):
        super().__init__(operand)
        self._shape = (operand.shape[1], operand.shape[0])

    def generate_stencil(self):
        return periodic.transpose(self.operand.generate_stencil())

    def __str__(self):
        return f"{self.operand}.T"


# --- Binary expressions -----------------------------------------------------


class Addition(BinaryExpression):
    def __init__(self, operand1, operand2):
        self._shape = operand1.shape
        super().__init__(operand1, operand2)

    @property
    def shape(self):
        return self._shape

    def generate_stencil(self):
        return periodic.add(
            self.operand1.generate_stencil(), self.operand2.generate_stencil()
        )

    def __str__(self):
        return f"({self.operand1} + {self.operand2})"


class Subtraction(BinaryExpression):
    def __init__(self, operand1, operand2):
        self._shape = operand1.shape
        super().__init__(operand1, operand2)

    @property
    def shape(self):
        return self._shape

    def generate_stencil(self):
        return periodic.sub(
            self.operand1.generate_stencil(), self.operand2.generate_stencil()
        )

    def __str__(self):
        return f"({self.operand1} - {self.operand2})"


class Multiplication(BinaryExpression):
    def __init__(self, operand1, operand2):
        assert operand1.shape[1] == operand2.shape[0], "Operand shapes not aligned"
        self._shape = (operand1.shape[0], operand2.shape[1])
        super().__init__(operand1, operand2)

    @property
    def shape(self):
        return self._shape

    def generate_stencil(self):
        return periodic.mul(
            self.operand1.generate_stencil(), self.operand2.generate_stencil()
        )

    def __str__(self):
        return f"({self.operand1} * {self.operand2})"


class Scaling(Expression):
    def __init__(self, factor, operand):
        self._factor = factor
        self._operand = operand
        self._shape = operand.shape
        super().__init__()

    @property
    def factor(self):
        return self._factor

    @property
    def operand(self):
        return self._operand

    @property
    def grid(self):
        return self.operand.grid

    @property
    def shape(self):
        return self._shape

    def generate_stencil(self):
        return periodic.scale(self.factor, self.operand.generate_stencil())

    def apply(self, transform: callable, *args):
        return Scaling(self.factor, transform(self.operand, *args))

    def mutate(self, f: callable, *args):
        f(self.operand, *args)

    def __str__(self):
        return f"{self.factor} * {self.operand}"


# --- Intergrid operators ----------------------------------------------------


class InterGridOperator(Operator):
    def __init__(self, name, grid, fine_grid, coarse_grid, stencil_generator):
        self._fine_grid = fine_grid
        self._coarse_grid = coarse_grid
        super().__init__(name, grid, stencil_generator)

    @property
    def fine_grid(self):
        return self._fine_grid

    @property
    def coarse_grid(self):
        return self._coarse_grid


class Restriction(InterGridOperator):
    def __init__(self, name, fine_grid, coarse_grid, stencil_generator=None):
        super().__init__(name, coarse_grid, fine_grid, coarse_grid, stencil_generator)
        n_fine = reduce(_op.mul, fine_grid.size)
        n_coarse = reduce(_op.mul, coarse_grid.size)
        self._shape = (n_coarse, n_fine)

    @property
    def input_grid(self):
        return self.fine_grid

    @property
    def output_grid(self):
        return self.coarse_grid

    def __repr__(self):
        return f"Restriction({self.name!r}, {self.fine_grid!r}, {self.coarse_grid!r})"


class ZeroRestriction(Restriction):
    def __init__(self, fine_grid, coarse_grid, name="0"):
        from evostencils_torch.stencils.gallery import ZeroGenerator

        super().__init__(name, fine_grid, coarse_grid, ZeroGenerator(fine_grid.dimension))


class Prolongation(InterGridOperator):
    def __init__(self, name, fine_grid, coarse_grid, stencil_generator=None):
        super().__init__(name, fine_grid, fine_grid, coarse_grid, stencil_generator)
        n_fine = reduce(_op.mul, fine_grid.size)
        n_coarse = reduce(_op.mul, coarse_grid.size)
        self._shape = (n_fine, n_coarse)

    @property
    def input_grid(self):
        return self.coarse_grid

    @property
    def output_grid(self):
        return self.fine_grid

    def __repr__(self):
        return f"Prolongation({self.name!r}, {self.fine_grid!r}, {self.coarse_grid!r})"


class ZeroProlongation(Prolongation):
    def __init__(self, fine_grid, coarse_grid, name="0"):
        from evostencils_torch.stencils.gallery import ZeroGenerator

        super().__init__(name, fine_grid, coarse_grid, ZeroGenerator(fine_grid.dimension))


class CoarseGridSolver(Entity):
    """Exact (or user-supplied iterative) solve with the coarse operator.

    `expression` optionally holds a solver IR (e.g. a Krylov method) to be
    used instead of the direct inverse (reference ir/base.py:572-595).
    """

    def __init__(self, name, operator, expression=None):
        self._operator = operator
        self._expression = expression
        super().__init__(name, operator.grid, operator.shape)

    @property
    def operator(self):
        return self._operator

    @property
    def expression(self):
        return self._expression

    @staticmethod
    def generate_stencil():
        return None

    def mutate(self, f: callable, *args):
        f(self.operator, *args)

    def __repr__(self):
        return f"CoarseGridSolver({self.operator!r}, {self.expression!r})"


class Residual(Expression):
    """r = b - A x."""

    def __init__(self, operator, approximation, rhs):
        self._operator = operator
        self._approximation = approximation
        self._rhs = rhs
        super().__init__()

    @property
    def shape(self):
        return self.rhs.shape

    @property
    def grid(self):
        return self.rhs.grid

    @property
    def operator(self):
        return self._operator

    @property
    def approximation(self):
        return self._approximation

    @property
    def rhs(self):
        return self._rhs

    @staticmethod
    def generate_stencil():
        return None

    def generate_expression(self):
        return sub(self.rhs, mul(self.operator, self.approximation))

    def apply(self, transform: callable, *args):
        return Residual(
            transform(self.operator, *args),
            transform(self.approximation, *args),
            transform(self.rhs, *args),
        )

    def mutate(self, f: callable, *args):
        f(self.rhs, *args)
        f(self.approximation, *args)

    def __str__(self):
        return f"({self.rhs} - {self.operator} * {self.approximation})"


class Cycle(Expression):
    """One correction step: u_new = u + ω · correction (per partition sweep).

    `predecessor` links a coarse-level cycle back to the fine-level cycle it
    descends from — the grammar's level-splice mechanism
    (reference ir/base.py:651-697).
    """

    def __init__(
        self,
        approximation,
        rhs,
        correction=None,
        partitioning=part.Single,
        relaxation_factor=1.0,
        predecessor=None,
    ):
        self.approximation = approximation
        self.rhs = rhs
        self.correction = correction
        self.relaxation_factor = relaxation_factor
        self.partitioning = partitioning
        self.predecessor = predecessor
        self.global_id = None
        self.weight_obtained = False
        self.weight_set = False
        super().__init__()

    @property
    def shape(self):
        return self.approximation.shape

    @property
    def grid(self):
        return self.approximation.grid

    @staticmethod
    def generate_stencil():
        return None

    def generate_expression(self):
        return Addition(self.approximation, Scaling(self.relaxation_factor, self.correction))

    def apply(self, transform: callable, *args):
        return Cycle(
            transform(self.approximation, *args),
            transform(self.rhs, *args),
            transform(self.correction, *args),
            self.partitioning,
            self.relaxation_factor,
            self.predecessor,
        )

    def mutate(self, f: callable, *args):
        f(self.correction, *args)

    def __str__(self):
        return str(self.generate_expression())


# --- Convenience constructors ----------------------------------------------


def diag(operand):
    return Diagonal(operand)


def inv(operand):
    return Inverse(operand)


def add(operand1, operand2):
    return Addition(operand1, operand2)


def sub(operand1, operand2):
    return Subtraction(operand1, operand2)


def mul(operand1, operand2):
    return Multiplication(operand1, operand2)


def scale(factor, operand):
    return Scaling(factor, operand)


def minus(operand):
    return Scaling(-1, operand)


def is_quadratic(expression: Expression) -> bool:
    return expression.shape[0] == expression.shape[1]


# --- Grid hierarchy helpers --------------------------------------------------


def get_coarse_grid(grid: Grid, coarsening_factor):
    coarse_size = tuple(s // f for s, f in zip(grid.size, coarsening_factor))
    coarse_spacing = tuple(h * f for h, f in zip(grid.spacing, coarsening_factor))
    return Grid(coarse_size, coarse_spacing, grid.level - 1)


def get_coarse_approximation(approximation: Approximation, coarsening_factor):
    return Approximation(
        f"{approximation.name}_c", get_coarse_grid(approximation.grid, coarsening_factor)
    )


def get_coarse_rhs(rhs: RightHandSide, coarsening_factor):
    return RightHandSide(f"{rhs.name}_c", get_coarse_grid(rhs.grid, coarsening_factor))


def get_coarse_operator(operator, coarse_grid):
    return Operator(f"{operator.name}", coarse_grid, operator.stencil_generator)


class ConstantStencilGenerator:
    """Wrap a fixed stencil as a generator (reference ir/base.py:719-724)."""

    def __init__(self, stencil):
        self._stencil = stencil

    def generate_stencil(self, _):
        return self._stencil

    def is_variable(self):
        return False

    def __repr__(self):
        return f"ConstantStencilGenerator({self._stencil!r})"
