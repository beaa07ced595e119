"""IR → eager torch: lowers an evolved multigrid cycle to a step function
(counterpart of evostencils_tpu/backend/lowering.py).

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
    with a Krylov method: that many iterations of ops/krylov.py; with an
    evolved cycle of an earlier run (`apply_as_solver`, multi-run
    level splitting): that cycle once on (0, r).
  * Variable coefficients (2D/3D variable Poisson, Helmholtz with Robin
    boundaries): the operator is applied from the generator's coefficient
    planes, cast to the lowering's dtype and kept per (generator, grid);
    point smoothers invert per-point centre planes; the dense coarse solve
    is assembled from the planes.  Block smoothers of a variable operator
    take the constant stencil sampled at the generator's `position`, as in
    the reference.
  * Nonlinear (FAS) operators: the generator applies A(u) itself; the
    point smoothers are the reference's Picard and Newton point solves on
    the iterate; the coarsest solve is 200 damped (0.8) Picard sweeps
    started from the restricted solution R·u, which is taken structurally
    from the τ-corrected right-hand side.  The reference's `fori_loop` is
    a Python loop here.

A complex dtype (Helmholtz) keeps the complex centre coefficients and
inverses and takes the masked half-sweeps for red-black smoothing: the
fused sweep is float32 only, as the reference's Pallas gate, which also
refuses 3D, multi-field, variable and nonlinear operators.  The
reference's `lax.scan` smoothing chains exist to cut XLA compile time;
eager torch applies the same smoothing steps one after another.

`CycleLowering(..., mesh=...)` lowers for a (dp, sp) device mesh
(parallel/mesh.py): every state is this rank's rows of its grid, every op
takes the grid's slab (halo exchanges, global row offsets, all-reduced
inner products), and the kernel is off, as the reference turns its Pallas
kernels off under a mesh (evostencils_tpu/backend/lowering.py:73-81).  A
level whose slabs would hold fewer than `replicate_below` rows is held
whole on every rank: the RESTRICT into it gathers, the PROLONG out of it
cuts this rank's rows, and a dense coarse solve on a level still split
gathers its right-hand side.  A nonlinear (FAS) operator applies its
Laplacian on the slab with the same halo exchange; its point solves are
pointwise, and its 200 Picard sweeps run on the coarsest level whether the
replication rule holds that level whole or leaves it split.  Complex
coefficient planes (Helmholtz with Robin boundaries) are cut to the slab
as real ones are.

A step also runs a batch of same-structure cycles (the group path's
members, backend/evaluation.py): fields of shape (B, *grid) and, for
`lower_parameterized`, ω as a (B, slots) tensor, one row per member.  The
ops index the trailing grid axes, ω and the coefficient planes broadcast
over the members, every red-black sweep of a member level that the gate
takes is one batched launch of the kernel, and the Krylov coarse solves
take one inner product per member, so each member gets the bits its own
step would give it (on the CPU; on the card up to the order of the
per-member reductions).  Members take no mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from evostencils_torch import dtype_is_complex, numpy_dtype
from evostencils_torch.ir import base, system
from evostencils_torch.ir import partitioning as part
from evostencils_torch.ir.krylov import KrylovSubspaceMethod
from evostencils_torch.ir.transformations import canonical_string, collect_cycles
from evostencils_torch.ops import coarse_solve, intergrid, krylov, rb_sweep, smoothers
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.stencils import periodic


def _is_partitioning(p, kind) -> bool:
    return p is kind or isinstance(p, kind)


def _is_variable(gen) -> bool:
    return gen is not None and getattr(gen, "is_variable", lambda: False)()


def _is_nonlinear(gen) -> bool:
    return gen is not None and getattr(gen, "is_nonlinear", False)


def _constant_stencil(entry):
    """The entry's stencil, a periodic one as its constant view."""
    stencil = entry.generate_stencil()
    if isinstance(stencil, periodic.PeriodicStencil):
        stencil = stencil.as_constant()
    return stencil


def _has_members(x: torch.Tensor, grid) -> bool:
    """Whether a field on `grid` carries a leading member axis."""
    return x.dim() > len(grid.interior_shape)


def _center_plane(offsets, planes):
    """The zero-offset plane of a variable stencil (the last one listed)."""
    center = None
    for o, p in zip(offsets, planes):
        if all(x == 0 for x in o):
            center = p
    return center


class CycleLowering:
    def __init__(self, dtype=torch.float32, device="cuda", use_kernels=True, mesh=None,
                 replicate_below=64):
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.layout = None
        if mesh is not None:
            from evostencils_torch.parallel.mesh import MeshLayout

            self.layout = MeshLayout(mesh, replicate_below)
            # The reference's explicit multi-chip policy: the kernel
            # addresses the whole grid, so a mesh lowers through the plain
            # ops; never a silent gather.
            self.use_kernels = False
        self._dense_specs = {}
        self._block_specs = {}
        self._center_inv_cache = {}
        self._plane_cache = {}
        self._diagonal_inv_cache = {}

    # ------------------------------------------------------------------
    # Operator application helpers
    # ------------------------------------------------------------------

    def _slab(self, grid):
        """This rank's slab of `grid` (parallel/mesh.py), or None: no mesh,
        or a grid held whole by the replication rule."""
        return None if self.layout is None else self.layout.slab(grid.interior_shape)

    def local_shape(self, global_shape):
        """The shape of this rank's part of a grid of `global_shape`."""
        return tuple(global_shape) if self.layout is None else self.layout.local_shape(global_shape)

    def _cut(self, grid, array: np.ndarray) -> np.ndarray:
        """This rank's rows of a whole-grid numpy array (coefficient and
        inverse planes)."""
        slab = self._slab(grid)
        return array if slab is None else slab.cut(array)

    def _grid_key(self, gen, grid):
        """Cache key of a generator on a grid.  The caches keep `gen`
        itself, so its id stays its own while the entry lives; the grid is
        keyed by content, since every individual builds its own grids."""
        return (id(gen), grid.level, tuple(grid.size), tuple(grid.spacing))

    def _coefficient_planes(self, operator: base.Operator):
        """(offsets, planes) of a variable operator as tensors in the
        lowering's dtype on its device, made once per generator and grid."""
        gen = operator.stencil_generator
        key = self._grid_key(gen, operator.grid)
        if key not in self._plane_cache:
            offsets, planes = gen.generate_coefficient_arrays(operator.grid)
            np_dtype = numpy_dtype(self.dtype)
            self._plane_cache[key] = (gen, tuple(offsets), [
                torch.from_numpy(np.ascontiguousarray(
                    self._cut(operator.grid, np.asarray(p, dtype=np_dtype)))).to(self.device)
                for p in planes
            ])
        _, offsets, planes = self._plane_cache[key]
        return offsets, planes

    def entry_apply(self, entry, field):
        """Apply one scalar block entry of a system operator to a field."""
        if isinstance(entry, base.ZeroOperator):
            return torch.zeros_like(field)
        if isinstance(entry, base.Identity):
            return field
        gen = getattr(entry, "stencil_generator", None)
        if _is_nonlinear(gen):
            raise RuntimeError(
                "Nonlinear entries must be applied through system_apply with the iterate")
        slab = self._slab(entry.grid)
        if isinstance(entry, base.Operator) and _is_variable(gen):
            return sops.apply_variable_stencil(field, *self._coefficient_planes(entry), slab)
        stencil = entry.generate_stencil()
        if stencil is None:
            raise RuntimeError(f"Entry {entry!r} has no stencil")
        return sops.apply_stencil(field, stencil, slab)

    def system_apply(self, operator: system.Operator, state: Sequence) -> Tuple:
        out = []
        for row in operator.entries:
            acc = None
            for entry, field in zip(row, state):
                gen = getattr(entry, "stencil_generator", None)
                if _is_nonlinear(gen):
                    term = gen.apply(field, entry.grid, self._slab(entry.grid))
                elif isinstance(entry, base.ZeroOperator):
                    continue
                else:
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
            fine_shape = entry.fine_grid.interior_shape
            coarse_shape = entry.coarse_grid.interior_shape
            fine_slab, coarse_slab = self._slab(entry.fine_grid), self._slab(entry.coarse_grid)
            if isinstance(entry, base.Restriction):
                out.append(self._restrict(state[i], stencil, coarse_shape, cf,
                                          fine_slab, coarse_slab))
            elif isinstance(entry, base.Prolongation):
                out.append(self._prolong(state[i], stencil, fine_shape, cf,
                                         fine_slab, coarse_slab))
            else:
                raise RuntimeError(f"Not an intergrid entry: {entry!r}")
        return tuple(out)

    # A rank's fine slab holds the fine row of every coarse row it owns, so
    # a level held whole has only levels held whole below it.

    def _restrict(self, fine, stencil, coarse_shape, cf, fine_slab, coarse_slab):
        """Restriction, across the replication boundary where the coarse
        level is held whole: this rank's coarse rows, then the gather."""
        if fine_slab is None:
            return intergrid.restrict(fine, stencil, coarse_shape, cf)
        coarse = intergrid.restrict(fine, stencil, coarse_shape, cf, fine_slab)
        if coarse_slab is None:
            coarse = self.layout.gather(coarse, self.layout.rows_of(coarse_shape))
        return coarse

    def _prolong(self, coarse, stencil, fine_shape, cf, fine_slab, coarse_slab):
        """Prolongation, back across the replication boundary: a coarse level
        held whole gives this rank the coarse rows its fine rows need."""
        if fine_slab is None:
            return intergrid.prolong(coarse, stencil, fine_shape, cf)
        if coarse_slab is None:
            clo, chi = fine_slab.coarse_rows(cf[0])
            coarse = coarse[clo:chi]
        return intergrid.prolong(coarse, stencil, fine_slab.local_shape, cf, fine_slab)

    # ------------------------------------------------------------------
    # Smoothers: Inverse(B) · r
    # ------------------------------------------------------------------

    def _center_values(self, operator: system.Operator):
        """(mat, None): the (n, n) matrix of centre coefficients, or
        (None, mats): per-point (..., n, n) matrices when an entry has
        variable coefficients (from the generator's own float64 or
        complex128 planes, as the reference)."""
        n = len(operator.entries)
        variable = any(
            _is_variable(getattr(entry, "stencil_generator", None))
            for row in operator.entries for entry in row
        )
        if not variable:
            mat = np.zeros((n, n), dtype=np.complex128)
            for i, row in enumerate(operator.entries):
                for j, entry in enumerate(row):
                    stencil = _constant_stencil(entry)
                    if stencil is not None:
                        mat[i, j] = stencil.center_value()
            return mat, None
        shape = operator.entries[0][0].grid.interior_shape
        mats = np.zeros(tuple(shape) + (n, n), dtype=np.complex128)
        for i, row in enumerate(operator.entries):
            for j, entry in enumerate(row):
                gen = getattr(entry, "stencil_generator", None)
                if _is_variable(gen):
                    offsets, planes = gen.generate_coefficient_arrays(entry.grid)
                    for o, p in zip(offsets, planes):
                        if all(x == 0 for x in o):
                            mats[..., i, j] += p
                else:
                    stencil = _constant_stencil(entry)
                    if stencil is not None:
                        mats[..., i, j] += stencil.center_value()
        return None, mats

    def _elementwise_diagonal_inverse(self, operator: system.Operator):
        """("const", inv): the inverse (n, n) centre matrix, or
        ("planes", planes): planes[i][j] the per-point inverse as a tensor,
        None for a structurally zero coupling."""
        key = ("ed", canonical_string(operator))
        if key not in self._center_inv_cache:
            mat, mats = self._center_values(operator)
            inv = np.linalg.inv(mat if mats is None else mats)
            if not dtype_is_complex(self.dtype):
                inv = np.real(inv)
            if mats is None:
                result = ("const", inv)
            else:
                np_dtype = numpy_dtype(self.dtype)
                n = inv.shape[-1]
                grid = operator.entries[0][0].grid
                result = ("planes", [
                    [
                        torch.from_numpy(np.ascontiguousarray(
                            self._cut(grid, inv[..., i, j]), dtype=np_dtype)).to(self.device)
                        if np.any(inv[..., i, j]) else None
                        for j in range(n)
                    ]
                    for i in range(n)
                ])
            self._center_inv_cache[key] = result
        return self._center_inv_cache[key]

    def _diagonal_inverses(self, operator: system.Operator):
        """Per field 1/diag(A_ii): a number for a constant entry, a plane
        tensor for a variable one."""
        invs = []
        for i, row in enumerate(operator.entries):
            entry = row[i]
            gen = getattr(entry, "stencil_generator", None)
            if not _is_variable(gen):
                invs.append(sops.scalar(1.0 / _constant_stencil(entry).center_value()))
                continue
            key = self._grid_key(gen, entry.grid)
            if key not in self._diagonal_inv_cache:
                center = _center_plane(*gen.generate_coefficient_arrays(entry.grid))
                inv = np.asarray(1.0 / center, dtype=numpy_dtype(self.dtype))
                self._diagonal_inv_cache[key] = (
                    gen, torch.from_numpy(np.ascontiguousarray(
                        self._cut(entry.grid, inv))).to(self.device))
            invs.append(self._diagonal_inv_cache[key][1])
        return invs

    def _block_solve_spec(self, operator: system.Operator):
        """A block smoother's local solve.  As the reference, it is built
        from `entry.generate_stencil()`: for a variable operator the
        constant stencil sampled at the generator's `position`, for a
        nonlinear one its linearisation at u = 0."""
        key = canonical_string(operator)
        if key not in self._block_specs:
            entries = [[entry.generate_stencil() for entry in row] for row in operator.entries]
            self._block_specs[key] = smoothers.build_block_solve_spec(
                entries,
                [periodic.lift(entries[i][i]).period for i in range(len(entries))],
                operator.entries[0][0].grid.interior_shape,
                self.dtype,
                self.device,
            )
        return self._block_specs[key]

    def smoother_apply(self, smoothing_operator, r_state: Sequence, u_state=None) -> Tuple:
        """Apply B^{-1} to the residual state for a smoothing operator B.
        `u_state`, the current iterate, is needed by the nonlinear (FAS)
        point solves, whose local Jacobian depends on u."""
        B = smoothing_operator
        if isinstance(B, system.Diagonal):
            return smoothers.decoupled_jacobi_apply(r_state, self._diagonal_inverses(B.operand))
        if isinstance(B, system.ElementwiseDiagonal):
            nonlinear = self._nonlinear_entries(B.operand)
            if nonlinear is not None:
                return self._nonlinear_point_solve(nonlinear, r_state, u_state, newton_steps=None)
            kind, data = self._elementwise_diagonal_inverse(B.operand)
            if kind == "const":
                return smoothers.collective_jacobi_apply(r_state, data)
            return smoothers.collective_jacobi_apply_variable(r_state, data)
        if isinstance(B, system.Operator):
            return self._block_solve_spec(B).apply(r_state, self._slab(B.grid[0]))
        if isinstance(B, base.Addition) and isinstance(B.operand2, system.Jacobian):
            # FAS Newton smoother D + J: n Newton steps on the point-local
            # nonlinear equation.  On a linear operator it degenerates to
            # collective Jacobi.
            jacobian = B.operand2
            nonlinear = self._nonlinear_entries(jacobian.operand)
            if nonlinear is None:
                return self.smoother_apply(
                    system.ElementwiseDiagonal(jacobian.operand), r_state, u_state)
            return self._nonlinear_point_solve(
                nonlinear, r_state, u_state, newton_steps=jacobian.n_newton_steps)
        raise RuntimeError(f"Cannot apply smoother {B!r}")

    def _nonlinear_point_solve(self, gens, r_state, u_state, newton_steps):
        """Point-local solve of L_c·δ + N(u+δ) − N(u) = r per field.

        Picard (newton_steps None): δ = r / (L_c + N'(u)) with the
        nonlinearity frozen; Newton: n Newton iterations of the scalar
        local equation, n = 1 reducing to the same formula."""
        if u_state is None:
            raise RuntimeError("Nonlinear smoothing requires the current iterate")
        out = []
        for entry, r, u in zip(gens, r_state, u_state):
            if entry is None:
                out.append(r)
                continue
            gen, grid = entry
            center = gen.linear_center(grid)
            if newton_steps is None:
                delta = r / (center + gen.derivative_diag(u))
            else:
                n_u = gen.nonlinear_term(u)
                delta = torch.zeros_like(r)
                for _ in range(int(newton_steps)):
                    residual_loc = r - center * delta - (gen.nonlinear_term(u + delta) - n_u)
                    delta = delta + residual_loc / (center + gen.derivative_diag(u + delta))
            out.append(delta)
        return tuple(out)

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
                    if _is_variable(gen):
                        mats.append(coarse_solve.assemble_scalar_matrix(
                            None, entry.grid.interior_shape,
                            planes=gen.generate_coefficient_arrays(entry.grid)))
                    else:
                        mats.append(coarse_solve.assemble_scalar_matrix(
                            entry.generate_stencil(), entry.grid.interior_shape))
                entry_matrices.append(mats)
            self._dense_specs[key] = coarse_solve.build_dense_solve_spec(
                entry_matrices, field_shapes, self.dtype, self.device
            )
        return self._dense_specs[key]

    def cgs_apply(self, solver: base.CoarseGridSolver, r_state: Sequence,
                  rhs_expr=None, ev=None) -> Tuple:
        expr = solver.expression
        nonlinear = self._nonlinear_entries(solver.operator)
        if nonlinear is not None:
            return self._nonlinear_coarse_solve(solver.operator, nonlinear, r_state, rhs_expr, ev)
        grid = solver.operator.grid[0]
        slab = self._slab(grid)
        if expr is None:
            if slab is None:
                return self._dense_spec(solver.operator).apply(r_state)
            # The dense solve needs the whole vector: a coarsest level that
            # the replication rule left split gathers it (counted).
            whole = tuple(self.layout.gather(r, slab) for r in r_state)
            return tuple(slab.cut(x) for x in self._dense_spec(solver.operator).apply(whole))
        if isinstance(expr, KrylovSubspaceMethod):
            apply_a = partial(self.system_apply, expr.operator)
            return krylov.SOLVERS[expr.name](
                apply_a, tuple(r_state), expr.number_of_iterations, slab=slab,
                members=_has_members(r_state[0], grid))
        if hasattr(expr, "apply_as_solver"):
            # Nested evolved cycle from a previous optimization run
            # (multi-run level splitting): run it once on (0, r).
            return expr.apply_as_solver(self, tuple(r_state))
        raise RuntimeError(f"Unsupported coarse-grid solver expression {expr!r}")

    # The reference's nonlinear coarsest solve: 200 Picard sweeps damped by
    # 0.8 (the FAS template's CGS@coarsest).
    NONLINEAR_COARSE_SWEEPS = 200
    NONLINEAR_COARSE_DAMPING = 0.8

    def _nonlinear_coarse_solve(self, operator, nonlinear, r_state, rhs_expr, ev):
        """FAS coarsest solve, started from the restricted solution R·u: the
        τ-corrected right-hand side is R·r + A_c(R·u), and a start from zero
        would leave a bias that stalls the cycle at a wrong fixed point.
        R·u is the operand of the rhs's nonlinear operator product."""
        u = None
        if rhs_expr is not None and ev is not None and isinstance(rhs_expr, base.Addition):
            for candidate in (rhs_expr.operand2, rhs_expr.operand1):
                if (
                    isinstance(candidate, base.Multiplication)
                    and isinstance(candidate.operand1, system.Operator)
                    and self._nonlinear_entries(candidate.operand1) is not None
                ):
                    u = tuple(ev(candidate.operand2))
                    break
        if u is None:
            u = tuple(torch.zeros_like(r) for r in r_state)
        damping = self.NONLINEAR_COARSE_DAMPING
        for _ in range(self.NONLINEAR_COARSE_SWEEPS):
            r = sops.tree_sub(tuple(r_state), self.system_apply(operator, u))
            corr = self._nonlinear_point_solve(nonlinear, r, u, newton_steps=None)
            u = tuple(x + damping * c for x, c in zip(u, corr))
        return u

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

        step.layout = self.layout
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
            if torch.is_tensor(omegas) and omegas.dim() == 2:
                # One row of ω per member, each viewed to scale its member.
                return self._walk(expression, u, f, lambda node: sops.per_member(
                    omegas[:, slots[id(node)]], u[0]))
            if torch.is_tensor(omegas):
                return self._walk(expression, u, f, lambda node: omegas[slots[id(node)]])
            return self._walk(expression, u, f, lambda node: float(omegas[slots[id(node)]]))

        step.layout = self.layout
        return step, omega_values

    def _walk(self, expression, u, f, omega_lookup):
        memo = {}

        def ev(node):
            key = id(node)
            if key not in memo:
                memo[key] = self._eval(node, ev, u, f, omega_lookup)
            return memo[key]

        return ev(expression)

    def _zeros_for(self, node, u) -> Tuple:
        """Zero fields on the node's grids, with the members of the cycle's
        iterate `u` if it has any."""
        grids = node.grid if isinstance(node.grid, list) else [node.grid]
        members = sops.member_shape(u[0], len(grids[0].interior_shape))
        return tuple(
            torch.zeros(members + self.local_shape(g.interior_shape), dtype=self.dtype,
                        device=self.device)
            for g in grids
        )

    def _eval(self, node, ev, u, f, omega_lookup):
        if isinstance(node, (system.ZeroApproximation, base.ZeroApproximation)):
            return self._zeros_for(node, u)
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
                u_state = (
                    ev(node.operand2.approximation)
                    if isinstance(node.operand2, base.Residual) else None
                )
                return self.smoother_apply(op1.operand, ev(node.operand2), u_state)
            if isinstance(op1, base.CoarseGridSolver):
                return self.cgs_apply(op1, ev(node.operand2), node.operand2, ev)
            if isinstance(op1, KrylovSubspaceMethod):
                apply_a = partial(self.system_apply, op1.operator)
                rhs = ev(node.operand2)
                grid = op1.operator.grid[0]
                return krylov.SOLVERS[op1.name](
                    apply_a, rhs, op1.number_of_iterations, slab=self._slab(grid),
                    members=_has_members(rhs[0], grid))
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
            corr = self.smoother_apply(B, r, u_cur)
            return tuple(x + omega * c for x, c in zip(u_cur, corr))
        fused = self._try_fused_rb_sweep(B, A, u_cur, f_val, omega)
        if fused is not None:
            return fused
        slabs = [self._slab(g) for g in A.grid]
        masks_per_field = [
            sops.red_black_masks(sops.grid_shape(x, len(g.interior_shape)), x.dtype, x.device,
                                 0 if s is None else s.lo % 2)
            for x, s, g in zip(u_cur, slabs, A.grid)
        ]
        for color in range(2):
            r = sops.tree_sub(tuple(f_val), self.system_apply(A, u_cur))
            corr = self.smoother_apply(B, r, u_cur)
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
        grid = sops.grid_shape(u0[0], len(entry.grid.interior_shape))
        if not rb_sweep.supports_rb_sweep(grid, stencil, u0[0].dtype, self._slab(entry.grid)):
            return None
        return (rb_sweep.red_black_collective_jacobi_sweep(u0[0], f_val[0], omega, stencil),)
