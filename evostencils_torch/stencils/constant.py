"""Constant (position-independent) sparse stencil algebra.

A stencil is a sparse matrix row expressed as a set of (offset, value)
pairs on a structured grid.  This module provides the full operator
algebra needed by the multigrid IR: splitting (diagonal/lower/upper),
transposition, diagonal inversion, linear combination and stencil
composition (= matrix-matrix product of the induced Toeplitz operators).

Feature parity with the reference implementation
(upstream evostencils/stencils/constant.py:1-149); the code here is
an independent design: stencils are immutable, entries are kept in a
canonical lexicographically-sorted order so that stencils are hashable and
usable as compilation-cache keys for the JAX backend.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

Offset = Tuple[int, ...]
Entry = Tuple[Offset, complex]


def _canonicalize(entries: Iterable[Entry]) -> Tuple[Entry, ...]:
    merged = {}
    for offset, value in entries:
        offset = tuple(int(o) for o in offset)
        merged[offset] = merged.get(offset, 0) + value
    return tuple(sorted(merged.items(), key=lambda e: e[0]))


class Stencil:
    """Immutable sparse stencil: tuple of (offset-tuple, value) pairs."""

    __slots__ = ("_entries", "_dimension")

    def __init__(self, entries: Iterable[Entry], dimension: int | None = None):
        self._entries = _canonicalize(entries)
        if dimension is None:
            if not self._entries:
                raise ValueError("Empty stencil requires an explicit dimension")
            dimension = len(self._entries[0][0])
        self._dimension = dimension
        for offset, _ in self._entries:
            if len(offset) != dimension:
                raise ValueError(f"Offset {offset} does not match dimension {dimension}")

    @property
    def entries(self) -> Tuple[Entry, ...]:
        return self._entries

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def number_of_entries(self) -> int:
        return len(self._entries)

    @property
    def offsets(self) -> Tuple[Offset, ...]:
        return tuple(offset for offset, _ in self._entries)

    @property
    def values(self) -> Tuple[complex, ...]:
        return tuple(value for _, value in self._entries)

    def center_value(self):
        zero = (0,) * self.dimension
        for offset, value in self._entries:
            if offset == zero:
                return value
        return 0.0

    def max_reach(self) -> Tuple[int, ...]:
        """Maximum |offset| per axis — the halo width the stencil needs."""
        if not self._entries:
            return (0,) * self.dimension
        return tuple(
            max(abs(offset[axis]) for offset, _ in self._entries)
            for axis in range(self.dimension)
        )

    def is_diagonal(self) -> bool:
        zero = (0,) * self.dimension
        return all(offset == zero for offset, _ in self._entries)

    def __eq__(self, other):
        return (
            isinstance(other, Stencil)
            and self._dimension == other._dimension
            and self._entries == other._entries
        )

    def __hash__(self):
        return hash((self._dimension, self._entries))

    def __repr__(self):
        return f"Stencil({self._entries!r}, dimension={self._dimension})"


def map_stencil(stencil: Stencil | None, f: Callable[[Offset, complex], Entry]) -> Stencil | None:
    if stencil is None:
        return None
    return Stencil((f(o, v) for o, v in stencil.entries), stencil.dimension)


def filter_stencil(stencil: Stencil | None, predicate: Callable[[Offset, complex], bool]) -> Stencil | None:
    if stencil is None:
        return None
    return Stencil(
        ((o, v) for o, v in stencil.entries if predicate(o, v)), stencil.dimension
    )


def combine(stencil1: Stencil | None, stencil2: Stencil | None, f) -> Stencil | None:
    """Entry-wise combination aligned on offsets (missing entries are 0)."""
    if stencil1 is None or stencil2 is None:
        return None
    d1 = dict(stencil1.entries)
    d2 = dict(stencil2.entries)
    offsets = set(d1) | set(d2)
    return Stencil(
        ((o, f(d1.get(o, 0.0), d2.get(o, 0.0))) for o in offsets),
        stencil1.dimension,
    )


def _lexicographic_less(a: Offset, b: Offset) -> bool:
    return a < b


def diagonal(stencil: Stencil | None) -> Stencil | None:
    return filter_stencil(stencil, lambda o, _: all(i == 0 for i in o))


def lower(stencil: Stencil | None) -> Stencil | None:
    zero = None if stencil is None else (0,) * stencil.dimension
    return filter_stencil(stencil, lambda o, _: _lexicographic_less(o, zero))


def upper(stencil: Stencil | None) -> Stencil | None:
    zero = None if stencil is None else (0,) * stencil.dimension
    return filter_stencil(stencil, lambda o, _: _lexicographic_less(zero, o))


def transpose(stencil: Stencil | None) -> Stencil | None:
    return map_stencil(stencil, lambda o, v: (tuple(-i for i in o), v))


def conjugate_transpose(stencil: Stencil | None) -> Stencil | None:
    return map_stencil(
        stencil,
        lambda o, v: (tuple(-i for i in o), v.conjugate() if isinstance(v, complex) else v),
    )


def inverse(stencil: Stencil | None) -> Stencil | None:
    """Exact inverse — only defined for diagonal stencils."""

    def reciprocal(offset: Offset, value: complex) -> Entry:
        if any(i != 0 for i in offset):
            raise RuntimeError("Cannot invert a non-diagonal stencil exactly")
        if abs(value) < 1e-300:
            raise ZeroDivisionError("Stencil diagonal is (numerically) zero")
        return offset, 1.0 / value

    return map_stencil(stencil, reciprocal)


def add(stencil1, stencil2):
    return combine(stencil1, stencil2, lambda x, y: x + y)


def sub(stencil1, stencil2):
    return combine(stencil1, stencil2, lambda x, y: x - y)


def scale(factor, stencil):
    return map_stencil(stencil, lambda o, v: (o, factor * v))


def mul(stencil1: Stencil | None, stencil2: Stencil | None) -> Stencil | None:
    """Stencil composition: (S1*S2) u == S1 (S2 u) on an infinite grid."""
    if stencil1 is None or stencil2 is None:
        return None
    entries = []
    for offset2, value2 in stencil2.entries:
        for offset1, value1 in stencil1.entries:
            entries.append(
                (tuple(a + b for a, b in zip(offset1, offset2)), value1 * value2)
            )
    return Stencil(entries, stencil1.dimension)


def norm(stencil: Stencil) -> float:
    return math.sqrt(sum(abs(v) ** 2 for _, v in stencil.entries))


def get_unit_stencil(grid) -> Stencil:
    """Identity stencil for an object exposing .dimension."""
    return Stencil((((0,) * grid.dimension, 1.0),))


def get_null_stencil(grid) -> Stencil:
    return Stencil((), dimension=grid.dimension)


def identity(dimension: int) -> Stencil:
    return Stencil((((0,) * dimension, 1.0),))


def null(dimension: int) -> Stencil:
    return Stencil((), dimension=dimension)
