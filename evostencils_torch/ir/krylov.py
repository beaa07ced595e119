"""Krylov-subspace solver IR leaves (reference ir/krylov_subspace.py:4-45).

A KrylovSubspaceMethod behaves like a solver/smoother leaf: applying it to
a residual yields the approximate solution of `operator x = r` after a
fixed number of iterations.  The backend lowers each method to a
`lax.fori_loop` of fused stencil applications (ops/krylov.py) — static
iteration counts keep the whole solve inside one XLA computation.
"""

from evostencils_torch.ir.base import Entity


class KrylovSubspaceMethod(Entity):
    def __init__(self, name, operator, number_of_iterations):
        self._operator = operator
        self._number_of_iterations = number_of_iterations
        super().__init__(name, operator.grid, operator.shape)

    @staticmethod
    def generate_stencil():
        return None

    @property
    def operator(self):
        return self._operator

    @property
    def number_of_iterations(self):
        return self._number_of_iterations

    def __repr__(self):
        return (
            f"KrylovSubspaceMethod({self.name!r}, {self.operator!r}, "
            f"{self.number_of_iterations!r})"
        )


def generate_conjugate_gradient(operator, number_of_iterations):
    return KrylovSubspaceMethod("ConjugateGradient", operator, number_of_iterations)


def generate_bicgstab(operator, number_of_iterations):
    return KrylovSubspaceMethod("BiCGStab", operator, number_of_iterations)


def generate_minres(operator, number_of_iterations):
    return KrylovSubspaceMethod("MinRes", operator, number_of_iterations)


def generate_conjugate_residual(operator, number_of_iterations):
    return KrylovSubspaceMethod("ConjugateResidual", operator, number_of_iterations)
