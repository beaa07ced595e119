"""IR → eager torch: lowers an evolved multigrid cycle to a step function
(counterpart of evostencils_tpu/backend/lowering.py, linear path).

`CycleLowering(dtype, device).lower(cycle)` returns
`step(u_fields, f_fields) -> u_fields'`, which walks the IR and runs torch
ops on `device` (the card unless the caller asks for the CPU).  Semantics
as in the reference:
  * Cycle(u, f, corr, partitioning, ω): u' = u + ω·corr for Single; for
    RedBlack two masked half-sweeps with the residual recomputed against
    the updated iterate between colours.  A scalar 2D constant-stencil
    red-black collective-Jacobi step in float32 goes to the fused sweep
    (ops/rb_sweep.py), the CUDA kernel on the GPU, unless the lowering was
    built with `use_kernels=False` (the reference's `use_pallas=False`):
    the kernel has no backward, so the ω tuner differentiates through the
    masked half-sweeps instead.
  * Inverse(B)·r: Diagonal → per-field point Jacobi, ElementwiseDiagonal →
    per-point n_fields×n_fields solve, block-diagonal system.Operator →
    batched local dense solves.
  * CoarseGridSolver without an expression: precomputed dense inverse;
    with an evolved cycle of an earlier run (`apply_as_solver`, multi-run
    level splitting): that cycle once on (0, r).

Nonlinear (FAS) operators, Krylov coarse solves and variable coefficients
raise NotPortedError.  The reference's
`lax.scan` smoothing chains exist to cut XLA compile time; eager torch
applies the same smoothing steps one after another.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from evostencils_torch import NotPortedError
from evostencils_torch.ir import base, system
from evostencils_torch.ir import partitioning as part
from evostencils_torch.ir.krylov import KrylovSubspaceMethod
from evostencils_torch.ir.transformations import canonical_string, collect_cycles
from evostencils_torch.ops import coarse_solve, intergrid, rb_sweep, smoothers
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.stencils import periodic


def _is_partitioning(p, kind) -> bool:
    return p is kind or isinstance(p, kind)


def _is_variable(gen) -> bool:
    return gen is not None and getattr(gen, "is_variable", lambda: False)()


def _is_nonlinear(gen) -> bool:
    return gen is not None and getattr(gen, "is_nonlinear", False)


def _constant_stencil(entry):
    """The entry's stencil, a uniform periodic one as constant; raises
    NotPortedError for variable or nonlinear coefficients."""
    gen = getattr(entry, "stencil_generator", None)
    if _is_nonlinear(gen):
        raise NotPortedError("nonlinear (FAS) operators")
    if _is_variable(gen):
        raise NotPortedError("variable-coefficient operators")
    stencil = entry.generate_stencil()
    if isinstance(stencil, periodic.PeriodicStencil):
        stencil = stencil.as_constant()
    return stencil


class CycleLowering:
    def __init__(self, dtype=torch.float32, device="cuda", use_kernels=True):
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self._dense_specs = {}
        self._block_specs = {}
        self._center_inv_cache = {}

    # ------------------------------------------------------------------
    # Operator application helpers
    # ------------------------------------------------------------------

    def entry_apply(self, entry, field):
        """Apply one scalar block entry of a system operator to a field."""
        if isinstance(entry, base.ZeroOperator):
            return torch.zeros_like(field)
        if isinstance(entry, base.Identity):
            return field
        gen = getattr(entry, "stencil_generator", None)
        if _is_nonlinear(gen):
            raise NotPortedError("nonlinear (FAS) operators")
        if isinstance(entry, base.Operator) and _is_variable(gen):
            raise NotPortedError("variable-coefficient operators")
        stencil = entry.generate_stencil()
        if stencil is None:
            raise RuntimeError(f"Entry {entry!r} has no stencil")
        return sops.apply_stencil(field, stencil)

    def system_apply(self, operator: system.Operator, state: Sequence) -> Tuple:
        out = []
        for row in operator.entries:
            acc = None
            for entry, field in zip(row, state):
                if isinstance(entry, base.ZeroOperator):
                    continue
                term = self.entry_apply(entry, field)
                acc = term if acc is None else acc + term
            out.append(acc if acc is not None else torch.zeros_like(state[0]))
        return tuple(out)

    @staticmethod
    def _nonlinear_entries(operator: system.Operator):
        """Diagonal (i==i) nonlinear generators, or None if fully linear."""
        gens = []
        any_nonlinear = False
        for i, row in enumerate(operator.entries):
            gen = getattr(row[i], "stencil_generator", None)
            if _is_nonlinear(gen):
                any_nonlinear = True
                gens.append((gen, row[i].grid))
            else:
                gens.append(None)
        return gens if any_nonlinear else None

    def _coarsening_factors(self, fine_grid, coarse_grid):
        return tuple(f // c for f, c in zip(fine_grid.size, coarse_grid.size))

    def intergrid_apply(self, igop, state: Sequence) -> Tuple:
        out = []
        for i, row in enumerate(igop.entries):
            entry = row[i]
            stencil = entry.generate_stencil()
            if isinstance(stencil, periodic.PeriodicStencil):
                stencil = stencil.as_constant()
            cf = self._coarsening_factors(entry.fine_grid, entry.coarse_grid)
            if isinstance(entry, base.Restriction):
                out.append(intergrid.restrict(state[i], stencil, entry.coarse_grid.interior_shape, cf))
            elif isinstance(entry, base.Prolongation):
                out.append(intergrid.prolong(state[i], stencil, entry.fine_grid.interior_shape, cf))
            else:
                raise RuntimeError(f"Not an intergrid entry: {entry!r}")
        return tuple(out)

    # ------------------------------------------------------------------
    # Smoothers: Inverse(B) · r
    # ------------------------------------------------------------------

    def _elementwise_diagonal_inverse(self, operator: system.Operator):
        """Inverse of the (n,n) matrix of centre coefficients."""
        key = canonical_string(operator)
        if key not in self._center_inv_cache:
            n = len(operator.entries)
            mat = np.zeros((n, n), dtype=np.complex128)
            for i, row in enumerate(operator.entries):
                for j, entry in enumerate(row):
                    if isinstance(entry, base.ZeroOperator):
                        continue
                    stencil = _constant_stencil(entry)
                    if stencil is not None:
                        mat[i, j] = stencil.center_value()
            self._center_inv_cache[key] = np.real(np.linalg.inv(mat))
        return self._center_inv_cache[key]

    def _diagonal_inverses(self, operator: system.Operator):
        return [
            1.0 / _constant_stencil(row[i]).center_value()
            for i, row in enumerate(operator.entries)
        ]

    def _block_solve_spec(self, operator: system.Operator):
        key = canonical_string(operator)
        if key not in self._block_specs:
            for row in operator.entries:
                for entry in row:
                    gen = getattr(entry, "stencil_generator", None)
                    if _is_nonlinear(gen) or _is_variable(gen):
                        raise NotPortedError("block smoothers of non-constant operators")
            entries = [[entry.generate_stencil() for entry in row] for row in operator.entries]
            self._block_specs[key] = smoothers.build_block_solve_spec(
                entries,
                [periodic.lift(entries[i][i]).period for i in range(len(entries))],
                operator.entries[0][0].grid.interior_shape,
                self.dtype,
                self.device,
            )
        return self._block_specs[key]

    def smoother_apply(self, smoothing_operator, r_state: Sequence) -> Tuple:
        """Apply B^{-1} to the residual state for a smoothing operator B."""
        B = smoothing_operator
        if isinstance(B, system.Diagonal):
            return smoothers.decoupled_jacobi_apply(r_state, self._diagonal_inverses(B.operand))
        if isinstance(B, system.ElementwiseDiagonal):
            return smoothers.collective_jacobi_apply(
                r_state, self._elementwise_diagonal_inverse(B.operand)
            )
        if isinstance(B, system.Operator):
            return self._block_solve_spec(B).apply(r_state)
        if isinstance(B, base.Addition) and isinstance(B.operand2, system.Jacobian):
            raise NotPortedError("FAS Newton smoothing")
        raise RuntimeError(f"Cannot apply smoother {B!r}")

    # ------------------------------------------------------------------
    # Coarse-grid solver
    # ------------------------------------------------------------------

    def _dense_spec(self, operator: system.Operator):
        key = canonical_string(operator)
        if key not in self._dense_specs:
            entry_matrices = []
            field_shapes = [g.interior_shape for g in operator.grid]
            for row in operator.entries:
                mats = []
                for entry in row:
                    if isinstance(entry, base.ZeroOperator):
                        mats.append(None)
                        continue
                    gen = getattr(entry, "stencil_generator", None)
                    if _is_nonlinear(gen) or _is_variable(gen):
                        raise NotPortedError("dense coarse solves of non-constant operators")
                    mats.append(
                        coarse_solve.assemble_scalar_matrix(
                            entry.generate_stencil(), entry.grid.interior_shape
                        )
                    )
                entry_matrices.append(mats)
            self._dense_specs[key] = coarse_solve.build_dense_solve_spec(
                entry_matrices, field_shapes, self.dtype, self.device
            )
        return self._dense_specs[key]

    def cgs_apply(self, solver: base.CoarseGridSolver, r_state: Sequence) -> Tuple:
        expr = solver.expression
        if self._nonlinear_entries(solver.operator) is not None:
            raise NotPortedError("nonlinear (FAS) coarse-grid solves")
        if expr is None:
            return self._dense_spec(solver.operator).apply(r_state)
        if isinstance(expr, KrylovSubspaceMethod):
            raise NotPortedError(f"Krylov coarse-grid solver {expr.name}")
        if hasattr(expr, "apply_as_solver"):
            # Nested evolved cycle from a previous optimization run
            # (multi-run level splitting): run it once on (0, r).
            return expr.apply_as_solver(self, tuple(r_state))
        raise RuntimeError(f"Unsupported coarse-grid solver expression {expr!r}")

    # ------------------------------------------------------------------
    # Main recursive evaluation
    # ------------------------------------------------------------------

    def lower(self, expression: base.Expression) -> Callable:
        """Build step(u_fields, f_fields) -> new u_fields for one cycle,
        with each cycle's own relaxation factor as a Python float.

        Leaf resolution is type-based: the non-zero system.Approximation
        leaf binds to `u`, the system.RightHandSide leaf binds to `f`,
        ZeroApproximations evaluate to zeros."""

        def step(u: Tuple, f: Tuple) -> Tuple:
            return self._walk(expression, u, f, None)

        return step

    def lower_parameterized(self, expression: base.Expression):
        """Build step(u, f, omegas) with the relaxation factors as an
        argument in canonical slot order (`collect_cycles`).  Returns
        (step, omega_values).  A tensor `omegas` stays a tensor through the
        cycle (the ω tuner differentiates through it, and a device ω costs
        no host sync); a sequence of numbers gives Python floats."""
        cycles = collect_cycles(expression)
        slots = {id(c): i for i, c in enumerate(cycles)}
        omega_values = [float(c.relaxation_factor) for c in cycles]

        def step(u: Tuple, f: Tuple, omegas) -> Tuple:
            if torch.is_tensor(omegas):
                return self._walk(expression, u, f, lambda node: omegas[slots[id(node)]])
            return self._walk(expression, u, f, lambda node: float(omegas[slots[id(node)]]))

        return step, omega_values

    def _walk(self, expression, u, f, omega_lookup):
        memo = {}

        def ev(node):
            key = id(node)
            if key not in memo:
                memo[key] = self._eval(node, ev, u, f, omega_lookup)
            return memo[key]

        return ev(expression)

    def _zeros_for(self, node) -> Tuple:
        grids = node.grid if isinstance(node.grid, list) else [node.grid]
        return tuple(
            torch.zeros(g.interior_shape, dtype=self.dtype, device=self.device) for g in grids
        )

    def _eval(self, node, ev, u, f, omega_lookup):
        if isinstance(node, (system.ZeroApproximation, base.ZeroApproximation)):
            return self._zeros_for(node)
        if isinstance(node, (system.RightHandSide, base.RightHandSide)):
            return tuple(f)
        if isinstance(node, (system.Approximation, base.Approximation)):
            return tuple(u)
        if isinstance(node, base.Cycle):
            return self._eval_cycle(node, ev, omega_lookup)
        if isinstance(node, base.Residual):
            rhs_val = ev(node.rhs)
            approx_val = ev(node.approximation)
            return sops.tree_sub(rhs_val, self.system_apply(node.operator, approx_val))
        if isinstance(node, base.Multiplication):
            op1 = node.operand1
            if isinstance(op1, base.Inverse):
                return self.smoother_apply(op1.operand, ev(node.operand2))
            if isinstance(op1, base.CoarseGridSolver):
                return self.cgs_apply(op1, ev(node.operand2))
            if isinstance(op1, KrylovSubspaceMethod):
                raise NotPortedError(f"Krylov solver {op1.name}")
            if isinstance(op1, system.InterGridOperator):
                return self.intergrid_apply(op1, ev(node.operand2))
            if isinstance(op1, system.Operator):
                return self.system_apply(op1, ev(node.operand2))
            raise RuntimeError(f"Unsupported multiplication lhs: {op1!r}")
        if isinstance(node, base.Addition):
            return sops.tree_add(ev(node.operand1), ev(node.operand2))
        if isinstance(node, base.Subtraction):
            return sops.tree_sub(ev(node.operand1), ev(node.operand2))
        if isinstance(node, base.Scaling):
            return sops.tree_scale(node.factor, ev(node.operand))
        raise RuntimeError(f"Cannot evaluate IR node {type(node).__name__}")

    def _smoothing_parts(self, node: base.Cycle):
        """(B, A, rhs_expr, kind) if the cycle is a plain smoothing step
        u' = u + ω·P·B⁻¹(rhs − A·u) of its own iterate, else None.

        kind "single": full update — requires the residual to be formed
        against the cycle's own approximation.  kind "rb": the red-black
        two-sweep always recomputes the residual against the chained
        iterate, so only the correction's shape matters."""
        corr = node.correction
        if not (
            isinstance(corr, base.Multiplication)
            and isinstance(corr.operand1, base.Inverse)
            and isinstance(corr.operand2, base.Residual)
        ):
            return None
        residual = corr.operand2
        if _is_partitioning(node.partitioning, part.RedBlack):
            kind = "rb"
        elif (
            _is_partitioning(node.partitioning, part.Single)
            and residual.approximation is node.approximation
        ):
            kind = "single"
        else:
            return None
        return corr.operand1.operand, residual.operator, residual.rhs, kind

    def _apply_smoothing(self, u_cur, f_val, B, A, kind, omega):
        """One smoothing update u' = u + ω·P·B⁻¹(f − A·u) (both colours for
        red-black).  Shared by the IR walk and the cycle VM."""
        if kind == "single":
            r = sops.tree_sub(tuple(f_val), self.system_apply(A, u_cur))
            corr = self.smoother_apply(B, r)
            return tuple(x + omega * c for x, c in zip(u_cur, corr))
        fused = self._try_fused_rb_sweep(B, A, u_cur, f_val, omega)
        if fused is not None:
            return fused
        masks_per_field = [sops.red_black_masks(tuple(x.shape), x.dtype, x.device) for x in u_cur]
        for color in range(2):
            r = sops.tree_sub(tuple(f_val), self.system_apply(A, u_cur))
            corr = self.smoother_apply(B, r)
            u_cur = tuple(
                x + omega * masks[color] * c
                for x, c, masks in zip(u_cur, corr, masks_per_field)
            )
        return u_cur

    def _eval_cycle(self, node: base.Cycle, ev, omega_lookup=None):
        omega = float(node.relaxation_factor) if omega_lookup is None else omega_lookup(node)
        u0 = ev(node.approximation)
        if not _is_partitioning(node.partitioning, part.Single) and not _is_partitioning(
            node.partitioning, part.RedBlack
        ):
            raise RuntimeError(f"Unknown partitioning {node.partitioning!r}")
        info = self._smoothing_parts(node)
        if info is None:
            # Generic correction (coarse-grid or non-chained residual): one
            # full update; partitioning only applies to smoothing.
            corr = ev(node.correction)
            return tuple(x + omega * c for x, c in zip(u0, corr))
        B, A, rhs_expr, kind = info
        return self._apply_smoothing(tuple(u0), ev(rhs_expr), B, A, kind, omega)

    def _try_fused_rb_sweep(self, smoother_op, operator, u0, f_val, omega):
        """The red-black collective-Jacobi step as the fused sweep (the
        reference's Pallas gate: a scalar 2D constant-coefficient float32
        operator smoothed by its own elementwise diagonal); None to take
        the masked path."""
        if not self.use_kernels or not isinstance(smoother_op, system.ElementwiseDiagonal):
            return None
        if smoother_op.operand is not operator:
            return None
        if len(u0) != 1:
            return None
        entry = operator.entries[0][0]
        gen = getattr(entry, "stencil_generator", None)
        if gen is None or _is_nonlinear(gen) or _is_variable(gen):
            return None
        stencil = entry.generate_stencil()
        if isinstance(stencil, periodic.PeriodicStencil):
            if not stencil.is_uniform():
                return None
            stencil = stencil.as_constant()
        if not rb_sweep.supports_rb_sweep(tuple(u0[0].shape), stencil, u0[0].dtype):
            return None
        return (rb_sweep.red_black_collective_jacobi_sweep(u0[0], f_val[0], omega, stencil),)
