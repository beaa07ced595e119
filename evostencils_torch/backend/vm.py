"""Cycle VM: an evolved cycle as a flat instruction list (counterpart of
evostencils_tpu/backend/vm.py).

The grammar threads the state `(u, f)` linearly through every production,
so every linear-grammar tree is a straight-line program over a
level-indexed state:

    state   = (u[0..L], f[0..L])       one fields-tuple pair per level
    program = (opcodes int32[n], omegas float32[n], n)

ISA (branches are enumerated per level with the operators baked in):
    NOP
    SMOOTH[B, partitioning, level](ω)   u_l += ω·P·B⁻¹(f_l − A_l·u_l)
    RESTRICT[R, A, level]               f_{l+1} = R(f_l − A_l·u_l); u_{l+1} = 0
    CGS[solver, level]                  u_l = A_l⁻¹ f_l  (dense / Krylov / nested)
    PROLONG[P, level](ω)                u_l += ω·P·u_{l+1}

Registration and translation are the reference's, so both VMs number the
same branches alike.  The reference runs the program inside one compiled
`lax.switch` interpreter with the program passed in as data; here
`make_step` is a Python loop over the branches (programs need no padding),
and a CUDA graph captured from it takes the place of the compiled
interpreter (backend/graphs.py).  ω is one float32 tensor on the device
per program, and each instruction reads its 0-d view, so a graph holds no
ω of its own: one graph serves every program with the same opcodes, ω
mutations and same-structure groups included.  ω stays float32 as in the
reference, so it is rounded alike.

`include_block_smoothers=False` is the reference's slim ISA, which it
builds for outer-Krylov (Helmholtz) problems to keep its compiled
interpreter small.  Nothing is compiled here, but the rule decides which
individuals translate, and only those are probed before the outer solve
(backend/evaluation.py), so the fitness depends on it and the port keeps it.

On a lowering for a device mesh the branches run on this rank's slabs
(backend/lowering.py): the levels' iterates and right-hand sides are
allocated in the local shapes, and the ops exchange halos themselves.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from evostencils_torch.ir import base, partitioning as part, system
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.ops import stencil_ops as sops


class Program(NamedTuple):
    opcodes: np.ndarray  # int32[length]
    omegas: np.ndarray  # float32[length]; or a float32 tensor on the device
    length: int


def device_omegas(program: Program, device) -> torch.Tensor:
    """The program's ω as one float32 tensor on `device`: the tensor
    itself when it already is one, else the numpy vector carried across."""
    if torch.is_tensor(program.omegas):
        return program.omegas
    return torch.from_numpy(np.ascontiguousarray(program.omegas, dtype=np.float32)).to(device)


class _NotTranslatable(Exception):
    pass


def _replace(t: tuple, i: int, v):
    return t[:i] + (v,) + t[i + 1:]


class CycleVM:
    """Interpreter for one problem hierarchy (finest level fixed)."""

    def __init__(self, lowering, problem, finest_level: int,
                 include_block_smoothers: bool = True):
        self.lowering = lowering
        self.problem = problem
        self.include_block_smoothers = include_block_smoothers
        self.finest_level = finest_level
        self.n_levels = finest_level - problem.min_level + 1
        # Per-level interior shapes, one per field (0 = finest).
        self._shapes: List[List[tuple]] = [
            [g.interior_shape for g in problem.grid_at(finest_level - i)]
            for i in range(self.n_levels)
        ]
        self._op_index = {}
        self._branches = [self._nop_branch()]
        self.last_failure = None  # "not_translatable"
        self._preregister()

    # ------------------------------------------------------------------
    # ISA construction
    # ------------------------------------------------------------------

    def _nop_branch(self):
        def nop(state, omega):
            return state

        return nop

    def _opcode(self, key, make_branch) -> int:
        idx = self._op_index.get(key)
        if idx is None:
            idx = len(self._branches)
            self._branches.append(make_branch())
            self._op_index[key] = idx
        return idx

    def _level_index(self, expr) -> int:
        grids = expr.grid if isinstance(expr.grid, list) else [expr.grid]
        idx = self.finest_level - grids[0].level
        if not 0 <= idx < self.n_levels:
            raise _NotTranslatable(f"level {grids[0].level} outside hierarchy")
        return idx

    def _smooth_opcode(self, B, A, partitioning, level: int) -> int:
        if partitioning is part.RedBlack or isinstance(partitioning, part.RedBlack):
            kind = "rb"
        elif partitioning is part.Single or isinstance(partitioning, part.Single):
            kind = "single"
        else:
            raise _NotTranslatable(f"partitioning {partitioning!r}")
        if not self.include_block_smoothers and isinstance(B, system.Operator):
            raise _NotTranslatable("block smoother outside the slim ISA")
        key = ("smooth", level, kind, canonical_string(B))
        lowering = self.lowering

        def make():
            def branch(state, omega):
                u, f = state
                u_l = lowering._apply_smoothing(u[level], f[level], B, A, kind, omega)
                return (_replace(u, level, u_l), f)

            return branch

        return self._opcode(key, make)

    def _restrict_opcode(self, R, A, level: int) -> int:
        key = ("restrict", level, canonical_string(R), canonical_string(A))
        lowering = self.lowering
        coarse_shapes = self._shapes[level + 1]

        def make():
            def branch(state, omega):
                u, f = state
                r = sops.tree_sub(f[level], lowering.system_apply(A, u[level]))
                f_c = lowering.intergrid_apply(R, r)
                u_c = tuple(
                    torch.zeros(lowering.local_shape(s), dtype=lowering.dtype,
                                device=lowering.device)
                    for s in coarse_shapes
                )
                return (_replace(u, level + 1, u_c), _replace(f, level + 1, f_c))

            return branch

        return self._opcode(key, make)

    def _prolong_opcode(self, P, level: int) -> int:
        key = ("prolong", level, canonical_string(P))
        lowering = self.lowering

        def make():
            def branch(state, omega):
                u, f = state
                corr = lowering.intergrid_apply(P, u[level + 1])
                u_l = tuple(x + omega * c for x, c in zip(u[level], corr))
                return (_replace(u, level, u_l), f)

            return branch

        return self._opcode(key, make)

    def _cgs_opcode(self, solver: base.CoarseGridSolver, level: int) -> int:
        if self.lowering._nonlinear_entries(solver.operator) is not None:
            raise _NotTranslatable("nonlinear coarse solve")
        key = ("cgs", level, canonical_string(solver))
        lowering = self.lowering

        def make():
            def branch(state, omega):
                u, f = state
                return (_replace(u, level, lowering.cgs_apply(solver, f[level])), f)

            return branch

        return self._opcode(key, make)

    def _preregister(self):
        """Register the standard grammar surface up front, in the
        reference's order, so opcode numbers match the reference VM's."""
        from evostencils_torch.grammar import multigrid as mg
        from evostencils_torch.ir import smoother as sm

        problem = self.problem
        scalar = len(problem.fields) == 1
        max_block = 8
        block_shapes = []
        if scalar and self.include_block_smoothers:
            for shape in itertools.product(range(1, max_block + 1), repeat=problem.dimension):
                if 1 < int(np.prod(shape)) <= max_block:
                    block_shapes.append((shape,))

        for i in range(self.n_levels):
            level = self.finest_level - i
            grids = problem.grid_at(level)
            coarse = problem.grid_at(level - 1)
            if i == self.n_levels - 1:
                A = mg.generate_system_operator(
                    problem.equations, problem.operators, problem.fields, level, i, grids,
                )
                try:
                    self._cgs_opcode(base.CoarseGridSolver("CGS", A, None), i)
                except _NotTranslatable:
                    # A nonlinear (FAS) coarsest operator has no CGS branch.
                    pass
                break
            A, R, P = mg.generate_operators_on_level(
                problem.equations, problem.operators, problem.fields, level, i, grids, coarse,
            )
            for partitioning in (part.Single, part.RedBlack):
                self._smooth_opcode(sm.generate_collective_jacobi(A), A, partitioning, i)
                if not scalar:
                    self._smooth_opcode(sm.generate_decoupled_jacobi(A), A, partitioning, i)
            for bs in block_shapes:
                try:
                    self._smooth_opcode(
                        sm.generate_collective_block_jacobi(A, bs), A, part.Single, i
                    )
                except Exception:
                    # The reference skips a block shape its smoother
                    # generator rejects; skip the same ones here.
                    continue
            self._restrict_opcode(R, A, i)
            self._prolong_opcode(P, i)

    # ------------------------------------------------------------------
    # Translation: IR expression -> instruction list
    # ------------------------------------------------------------------

    def translate(self, expression) -> Optional[Program]:
        """Program for `expression`, or None if outside the ISA."""
        instrs: List[Tuple[int, float]] = []
        self.last_failure = None
        try:
            self._emit(expression, instrs)
        except _NotTranslatable:
            instrs = []
        if not instrs:
            self.last_failure = "not_translatable"
            return None
        opcodes = np.asarray([op for op, _ in instrs], dtype=np.int32)
        omegas = np.asarray([w for _, w in instrs], dtype=np.float32)
        return Program(opcodes, omegas, len(instrs))

    def _emit(self, expr, instrs):
        if isinstance(expr, (system.Approximation, base.Approximation)) and not isinstance(
            expr, (system.ZeroApproximation, base.ZeroApproximation)
        ):
            if self._level_index(expr) != 0:
                raise _NotTranslatable("non-finest initial approximation")
            return
        if isinstance(expr, (system.ZeroApproximation, base.ZeroApproximation)):
            # Base of a coarse chain: the preceding RESTRICT already zeroed
            # the iterate and bound the level's rhs.
            return
        if not isinstance(expr, base.Cycle):
            raise _NotTranslatable(f"unexpected node {type(expr).__name__}")

        level = self._level_index(expr)
        corr = expr.correction
        omega = float(expr.relaxation_factor)

        # Smoothing: u' = u + ω·P·B⁻¹(f − A·u)  (grammar `smoothing`).
        if (
            isinstance(corr, base.Multiplication)
            and isinstance(corr.operand1, base.Inverse)
            and isinstance(corr.operand2, base.Residual)
            and corr.operand2.approximation is expr.approximation
            and corr.operand2.rhs is expr.rhs
        ):
            self._emit(expr.approximation, instrs)
            opcode = self._smooth_opcode(
                corr.operand1.operand, corr.operand2.operator, expr.partitioning, level,
            )
            instrs.append((opcode, omega))
            return

        # Coarse-grid correction: u' = u + ω·P·(coarse result).
        if isinstance(corr, base.Multiplication) and isinstance(
            corr.operand1, system.InterGridOperator
        ):
            P, sub = corr.operand1, corr.operand2
            if isinstance(sub, base.Cycle):
                restrict_op = self._match_restricted_rhs(sub.rhs, expr, level)
                self._emit(expr.approximation, instrs)
                instrs.append((restrict_op, 1.0))
                self._emit(sub, instrs)
            elif isinstance(sub, base.Multiplication) and isinstance(
                sub.operand1, base.CoarseGridSolver
            ):
                restrict_op = self._match_restricted_rhs(sub.operand2, expr, level)
                self._emit(expr.approximation, instrs)
                instrs.append((restrict_op, 1.0))
                instrs.append((self._cgs_opcode(sub.operand1, level + 1), 1.0))
            else:
                raise _NotTranslatable("unrecognized coarse correction")
            instrs.append((self._prolong_opcode(P, level), omega))
            return

        raise _NotTranslatable("unrecognized correction shape")

    def _match_restricted_rhs(self, rhs_c, parent: base.Cycle, level: int) -> int:
        """rhs_c must be R·(f − A·u) of the parent's own state; returns the
        RESTRICT opcode."""
        if not (
            isinstance(rhs_c, base.Multiplication)
            and isinstance(rhs_c.operand1, system.InterGridOperator)
            and isinstance(rhs_c.operand2, base.Residual)
        ):
            raise _NotTranslatable("coarse rhs is not a restricted residual")
        residual = rhs_c.operand2
        if residual.approximation is not parent.approximation or residual.rhs is not parent.rhs:
            raise _NotTranslatable("restricted residual of a foreign state")
        return self._restrict_opcode(rhs_c.operand1, residual.operator, level)

    # ------------------------------------------------------------------
    # Interpreter
    # ------------------------------------------------------------------

    def make_step(self):
        """step(u_fields, f_fields, program) -> u_fields at the finest
        level, with the same call shape as the lowered step.  Instruction i
        reads ω as the 0-d view omegas[i] of `device_omegas(program)`; a
        numpy ω vector costs one host-to-device copy per call, so a caller
        that captures the step passes a program whose ω is a device tensor.
        The coarse levels start as zeros made inside the step, so a graph
        captured from it zeroes them at every replay."""
        branches = self._branches
        shapes = self._shapes
        lowering = self.lowering

        def zeros(level):
            return tuple(
                torch.zeros(lowering.local_shape(s), dtype=lowering.dtype, device=lowering.device)
                for s in shapes[level]
            )

        def step(u: Tuple, f: Tuple, program: Program) -> Tuple:
            u_all = (tuple(u),) + tuple(zeros(i) for i in range(1, len(shapes)))
            f_all = (tuple(f),) + tuple(zeros(i) for i in range(1, len(shapes)))
            state = (u_all, f_all)
            omegas = device_omegas(program, lowering.device)
            for i, op in enumerate(program.opcodes[:program.length].tolist()):
                state = branches[op](state, omegas[i])
            return state[0][0]

        step.layout = lowering.layout
        return step
