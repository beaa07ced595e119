"""Periodic (block-varying) stencil algebra.

A periodic stencil assigns a (possibly different) constant stencil to each
point of a d-dimensional period lattice; the assignment repeats with the
period over the whole grid.  This is the representation for red-black
sweep filters and block smoothers.

Parity of features with upstream evostencils/stencils/multiple.py:1-265,
re-designed around a numpy object-array of period cells instead of nested
tuples, which keeps the lifted algebra (map / combine with modular period
broadcasting) a handful of lines and makes the structure directly
consumable by the JAX lowering (ops/stencil_ops.py gathers per-parity
coefficient planes from the same layout).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from evostencils_torch.stencils import constant


class PeriodicStencil:
    """d-dimensional lattice of constant stencils, repeating periodically."""

    __slots__ = ("_cells", "_dimension")

    def __init__(self, cells: np.ndarray, dimension: int | None = None):
        cells = np.asarray(cells, dtype=object)
        if dimension is None:
            dimension = cells.ndim
        if cells.ndim != dimension:
            raise ValueError(f"Cell array rank {cells.ndim} != dimension {dimension}")
        self._cells = cells
        self._dimension = dimension

    @property
    def cells(self) -> np.ndarray:
        return self._cells

    @property
    def period(self) -> Tuple[int, ...]:
        return self._cells.shape

    @property
    def dimension(self) -> int:
        return self._dimension

    def __getitem__(self, index) -> constant.Stencil:
        return self._cells[tuple(i % p for i, p in zip(index, self.period))]

    def constant_stencils(self):
        return [s for s in self._cells.flat if s is not None]

    def is_uniform(self) -> bool:
        return self._cells.size == 1

    def as_constant(self) -> constant.Stencil:
        if not self.is_uniform():
            raise ValueError("Periodic stencil with period > 1 has no constant form")
        return self._cells.flat[0]

    def __eq__(self, other):
        return (
            isinstance(other, PeriodicStencil)
            and self.period == other.period
            and all(a == b for a, b in zip(self._cells.flat, other._cells.flat))
        )

    def __hash__(self):
        return hash((self.period, tuple(self._cells.flat)))

    def __repr__(self):
        return f"PeriodicStencil(period={self.period})"


def from_constant(stencil: constant.Stencil) -> PeriodicStencil:
    cells = np.empty((1,) * stencil.dimension, dtype=object)
    cells.flat[0] = stencil
    return PeriodicStencil(cells, stencil.dimension)


def lift(value) -> PeriodicStencil | None:
    """Coerce a constant stencil to periodic; pass through everything else."""
    if isinstance(value, constant.Stencil):
        return from_constant(value)
    return value


def count_number_of_entries(stencil) -> Tuple[int, ...]:
    stencil = lift(stencil)
    return tuple(s.number_of_entries for s in stencil.cells.flat if s is not None)


def get_list_of_entries(stencil) -> Tuple[constant.Stencil, ...]:
    stencil = lift(stencil)
    return tuple(s for s in stencil.cells.flat if s is not None)


def determine_maximal_shape(stencil) -> Tuple[int, ...]:
    return lift(stencil).period


def indexed_map_stencil(stencil, f: Callable) -> PeriodicStencil | None:
    stencil = lift(stencil)
    if stencil is None:
        return None
    cells = np.empty(stencil.period, dtype=object)
    for index in np.ndindex(*stencil.period):
        cells[index] = f(stencil.cells[index], index)
    return PeriodicStencil(cells, stencil.dimension)


def map_stencil(stencil, f: Callable) -> PeriodicStencil | None:
    return indexed_map_stencil(stencil, lambda s, _: f(s))


def indexed_combine(stencil1, stencil2, f: Callable) -> PeriodicStencil | None:
    stencil1, stencil2 = lift(stencil1), lift(stencil2)
    if stencil1 is None or stencil2 is None:
        return None
    if stencil1.dimension != stencil2.dimension:
        raise ValueError("Dimensions must match")
    period = tuple(
        max(p, q) for p, q in zip(stencil1.period, stencil2.period)
    )
    cells = np.empty(period, dtype=object)
    for index in np.ndindex(*period):
        cells[index] = f(stencil1[index], stencil2[index], index)
    return PeriodicStencil(cells, stencil1.dimension)


def combine(stencil1, stencil2, f: Callable) -> PeriodicStencil | None:
    return indexed_combine(stencil1, stencil2, lambda a, b, _: f(a, b))


def diagonal(stencil):
    return map_stencil(stencil, constant.diagonal)


def lower(stencil):
    return map_stencil(stencil, constant.lower)


def upper(stencil):
    return map_stencil(stencil, constant.upper)


def transpose(stencil):
    return map_stencil(stencil, constant.transpose)


def inverse(stencil):
    return map_stencil(stencil, constant.inverse)


def add(stencil1, stencil2):
    return combine(stencil1, stencil2, constant.add)


def sub(stencil1, stencil2):
    return combine(stencil1, stencil2, constant.sub)


def mul(stencil1, stencil2):
    return combine(stencil1, stencil2, constant.mul)


def scale(factor, stencil):
    return map_stencil(stencil, lambda s: constant.scale(factor, s))


def is_diagonal(stencil) -> bool:
    stencil = lift(stencil)
    return all(
        s.is_diagonal() for s in stencil.cells.flat if s is not None
    )


def block_diagonal(stencil, block_size: Tuple[int, ...]) -> PeriodicStencil:
    """Restrict stencil couplings to non-overlapping blocks of `block_size`.

    The grid is tiled by blocks; the cell at in-block position `index`
    keeps only offsets that stay inside its own block.  The result is the
    block-diagonal part of the operator (the local matrix each block
    smoother solves).  Mirrors reference multiple.py:204-217.
    """
    stencil = lift(stencil)
    if len(block_size) != stencil.dimension:
        raise ValueError("Block size does not match stencil dimension")

    def restrict_cell(cell: constant.Stencil, index) -> constant.Stencil:
        def inside(offset, _):
            target = tuple(i + o for i, o in zip(index, offset))
            return all(0 <= t < b for t, b in zip(target, block_size))

        return constant.filter_stencil(cell, inside)

    cells = np.empty(block_size, dtype=object)
    for index in np.ndindex(*block_size):
        cells[index] = restrict_cell(stencil[index], index)
    return PeriodicStencil(cells, stencil.dimension)


def red_black_partitioning(stencil, grid):
    """Return (red, black) filter stencils over a doubled period lattice.

    A point belongs to the red partition iff the sum of its period-block
    coordinates is even (reference multiple.py:220-240).  For plain
    period-1 stencils this is the classic checkerboard.
    """
    stencil = lift(stencil)
    if stencil is None:
        return None
    base_period = stencil.period
    shape = tuple(2 * p for p in base_period)
    unit = constant.get_unit_stencil(grid)
    nullst = constant.get_null_stencil(grid)

    red_cells = np.empty(shape, dtype=object)
    black_cells = np.empty(shape, dtype=object)
    for index in np.ndindex(*shape):
        is_red = sum(i // p for i, p in zip(index, base_period)) % 2 == 0
        red_cells[index] = unit if is_red else nullst
        black_cells[index] = nullst if is_red else unit
    return (
        PeriodicStencil(red_cells, stencil.dimension),
        PeriodicStencil(black_cells, stencil.dimension),
    )
