"""Smoother operator factories (reference ir/smoother.py:1-46).

Each factory turns a system operator A into the *smoothing operator* B so
that the grammar emits corrections of the form Inverse(B) * Residual(A,u,f).
"""

from evostencils_torch.ir import base, system
from evostencils_torch.stencils import periodic


def generate_decoupled_jacobi(operator: system.Operator):
    """B = diag of each diagonal block — per-field point Jacobi."""
    return system.Diagonal(operator)


def generate_collective_jacobi(operator: system.Operator):
    """B = per-gridpoint coupling of all fields' center coefficients."""
    return system.ElementwiseDiagonal(operator)


def generate_collective_block_jacobi(operator: system.Operator, block_sizes):
    """B = block-diagonal restriction of every block entry; the local system
    couples all fields over a small spatial block (solved directly)."""
    entries = []
    for i, row in enumerate(operator.entries):
        entries.append([])
        for j, entry in enumerate(row):
            stencil = entry.generate_stencil()
            block_diag = periodic.block_diagonal(stencil, block_sizes[i])
            entries[-1].append(
                base.Operator(
                    f"{operator.name}_{i}{j}_block_diag",
                    entry.grid,
                    base.ConstantStencilGenerator(block_diag),
                )
            )
    return system.Operator(f"{operator.name}_block_diag", entries)


def generate_decoupled_block_jacobi(operator: system.Operator, block_sizes):
    entries = []
    for i, row in enumerate(operator.entries):
        entries.append([])
        for j, entry in enumerate(row):
            if i == j:
                stencil = entry.generate_stencil()
                block_diag = periodic.block_diagonal(stencil, block_sizes)
                entries[-1].append(
                    base.Operator(
                        f"{operator.name}_{i}{j}_block_diag",
                        entry.grid,
                        base.ConstantStencilGenerator(block_diag),
                    )
                )
            else:
                entries[-1].append(base.ZeroOperator(entry.grid))
    return system.Operator(f"{operator.name}_block_diag", entries)


def generate_jacobi_picard(operator: system.Operator):
    """FAS Picard smoother: freeze the nonlinearity, point-Jacobi on D."""
    return system.ElementwiseDiagonal(operator)


def generate_jacobi_newton(operator: system.Operator, n_newton_steps: int):
    """FAS Newton smoother: D + J with n inner Newton steps."""
    return base.Addition(
        system.ElementwiseDiagonal(operator), system.Jacobian(operator, n_newton_steps)
    )
