"""Identifier-based grammar types with a guard flag.

Types are compared by identifier (not Python class), so per-depth type
universes can be spliced by aliasing (reference grammar/typing.py:1-13).
The `guard` flag implements the completeness discipline: the start
terminal is guarded and only the coarsest-grid-solver production maps a
guarded state back to an unguarded one, so every complete derivation must
reach the coarsest-grid solve (reference grammar/multigrid.py:384,431-432).
"""


class Type:
    __slots__ = ("identifier", "guard")

    def __init__(self, identifier: str, guard: bool = False):
        self.identifier = identifier
        self.guard = guard

    def __eq__(self, other):
        return (
            isinstance(other, Type)
            and self.identifier == other.identifier
            and self.guard == other.guard
        )

    def __hash__(self):
        return hash((self.identifier, self.guard))

    def __repr__(self):
        return f"Type({self.identifier!r}, guard={self.guard})"
