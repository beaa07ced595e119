"""Hand-constructed textbook cycles for validation (golden references).

Parity with upstream evostencils/ir/reference_cycles.py:5-277 —
V(2,2) two-/three-grid cycles with collective Jacobi smoothing, plus FAS
variants showing the τ-correction construction.  Used by the test suite to
pin the backend's numerics against known-good multigrid behavior.
"""

from __future__ import annotations

from evostencils_torch.ir import base, smoother
from evostencils_torch.ir import partitioning as part


def _smooth(u, f, A, omega, partitioning, steps=1, smoother_factory=None):
    factory = smoother_factory or smoother.generate_collective_jacobi
    for _ in range(steps):
        residual = base.Residual(A, u, f)
        correction = base.Multiplication(base.Inverse(factory(A)), residual)
        u = base.Cycle(u, f, correction, partitioning=partitioning, relaxation_factor=omega)
    return u


def generate_v_22_cycle_two_grid(terminals, rhs, omega=1.0, partitioning=part.RedBlack):
    """V(2,2) two-grid: 2 pre-smooths, exact coarse solve, 2 post-smooths."""
    u, f, A = terminals.approximation, rhs, terminals.operator
    P, R = terminals.prolongation, terminals.restriction

    u = _smooth(u, f, A, omega, partitioning, steps=2)
    residual = base.Residual(A, u, f)
    f_c = base.Multiplication(R, residual)
    A_c = terminals.coarse_operator
    correction_c = base.Multiplication(base.CoarseGridSolver("CGS", A_c), f_c)
    correction = base.Multiplication(P, correction_c)
    u = base.Cycle(u, f, correction, relaxation_factor=omega)
    u = _smooth(u, f, A, omega, partitioning, steps=2)
    return u


def generate_v_22_cycle_three_grid(
    terminals_fine, terminals_coarse, rhs, omega=1.0, partitioning=part.RedBlack
):
    """V(2,2) three-grid with recursive structure and predecessor links."""
    u, f, A = terminals_fine.approximation, rhs, terminals_fine.operator
    P, R = terminals_fine.prolongation, terminals_fine.restriction

    u = _smooth(u, f, A, omega, partitioning, steps=2)

    residual = base.Residual(A, u, f)
    f_c = base.Multiplication(R, residual)
    u_c = terminals_coarse.approximation
    A_c = terminals_fine.coarse_operator

    u_c = _smooth(u_c, f_c, A_c, omega, partitioning, steps=2)
    residual_c = base.Residual(A_c, u_c, f_c)
    f_cc = base.Multiplication(terminals_coarse.restriction, residual_c)
    A_cc = terminals_coarse.coarse_operator
    correction_cc = base.Multiplication(base.CoarseGridSolver("CGS", A_cc), f_cc)
    correction_c = base.Multiplication(terminals_coarse.prolongation, correction_cc)
    u_c = base.Cycle(u_c, f_c, correction_c, relaxation_factor=omega)
    u_c = _smooth(u_c, f_c, A_c, omega, partitioning, steps=2)

    correction = base.Multiplication(P, u_c)
    u = base.Cycle(u, f, correction, relaxation_factor=omega)
    u = _smooth(u, f, A, omega, partitioning, steps=2)
    return u


def generate_v_cycle(
    terminal_list,
    rhs,
    pre_smoothing=2,
    post_smoothing=2,
    omega=1.0,
    partitioning=part.RedBlack,
    level_index=0,
):
    """Recursive V(pre,post) cycle over the full `terminal_list` hierarchy,
    with an exact (dense) solve on the coarsest grid.  The canonical
    baseline solver — the analog of ExaStencils' default `generate solver`
    configuration (2D_FD_Poisson_fromL2.exa3: RBGS 2-pre/1-post + coarse CG)."""
    terminals = terminal_list[level_index]
    u, f, A = terminals.approximation, rhs, terminals.operator
    u = _smooth(u, f, A, omega, partitioning, steps=pre_smoothing)

    residual = base.Residual(A, u, f)
    f_c = base.Multiplication(terminals.restriction, residual)
    A_c = terminals.coarse_operator
    if level_index + 1 < len(terminal_list):
        coarse_u = generate_v_cycle(
            terminal_list,
            f_c,
            pre_smoothing,
            post_smoothing,
            omega,
            partitioning,
            level_index + 1,
        )
        correction = base.Multiplication(terminals.prolongation, coarse_u)
    else:
        correction_c = base.Multiplication(base.CoarseGridSolver("CGS", A_c), f_c)
        correction = base.Multiplication(terminals.prolongation, correction_c)
    u = base.Cycle(u, f, correction, relaxation_factor=omega)
    u = _smooth(u, f, A, omega, partitioning, steps=post_smoothing)
    return u


def generate_fas_v_22_cycle_two_grid(terminals, rhs, omega=1.0, partitioning=part.RedBlack):
    """FAS two-grid V(2,2): f_c = R·r + A_c·(R·u); corr = P·(u_c − R·u)
    (reference ir/reference_cycles.py:131-178)."""
    u, f, A = terminals.approximation, rhs, terminals.operator
    P, R = terminals.prolongation, terminals.restriction
    A_c = terminals.coarse_operator

    u = _smooth(u, f, A, omega, partitioning, steps=2)

    residual = base.Residual(A, u, f)
    f1_c = base.Multiplication(R, residual)
    restricted_u = base.Multiplication(R, u)
    f2_c = base.Multiplication(A_c, restricted_u)
    f_c = base.Addition(f1_c, f2_c)
    solution_c = base.Multiplication(base.CoarseGridSolver("CGS", A_c), f_c)
    correction_c = base.Subtraction(solution_c, restricted_u)
    correction = base.Multiplication(P, correction_c)
    u = base.Cycle(u, f, correction, relaxation_factor=omega)

    u = _smooth(u, f, A, omega, partitioning, steps=2)
    return u
