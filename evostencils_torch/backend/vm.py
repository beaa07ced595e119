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
same branches alike, bump `isa_version` alike (every registration, the
lazy ones of a CMA-ES transfer stencil or a Krylov coarse solve included)
and refuse a program longer than the reference's largest pad class
(`last_failure = "pad_overflow"`).  The reference runs the program inside
one compiled `lax.switch` interpreter with the program passed in as data.
Here it has two forms:

  * `make_step`, a Python loop over the branches: the eager form, which
    the CPU and `cuda_graphs=False` run;
  * `LevelState`, the interpreter's static state (every level's iterate
    and right-hand side, allocated once, a device program counter `pc` and
    a static float32 ω buffer of `PAD_CLASSES[-1]` entries) with one body
    per branch that reads its ω as `omegas[pc]` on the device, runs the
    branch's ops, writes the levels it changes back into the state and
    advances `pc`.  backend/graphs.Interpreter captures each body once in
    a CUDA graph and runs a program as the prologue's graph and then its
    branches' graphs in order, so one set of graphs per problem hierarchy
    runs every translated cycle and a new structure captures nothing but
    the branches it uses for the first time.

Both forms run the same ops in the same order on the same ω (float32, as
in the reference, so it is rounded alike), so they give the same bits.

`include_block_smoothers=False` is the reference's slim ISA, which it
builds for outer-Krylov (Helmholtz) problems to keep its compiled
interpreter small.  Nothing is compiled here, but the rule decides which
individuals translate, and only those are probed before the outer solve
(backend/evaluation.py), so the fitness depends on it and the port keeps it.

On a lowering for a device mesh the branches run on this rank's slabs
(backend/lowering.py): the levels' iterates and right-hand sides are
allocated in the local shapes, and the ops exchange halos themselves.

A batch of same-structure programs (the group path, backend/evaluation.py)
runs as one program with members: a `Program` whose ω is a (B, length)
array, one row per member, over levels shaped (B, *local).  As in the
reference's vmap over the program's ω slice, only ω is batched, never the
opcodes.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from evostencils_torch.ir import base, partitioning as part, system
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.ops import stencil_ops as sops

# The reference pads programs to the smallest of its classes and compiles
# its interpreter per class; no legal tree (the grammar caps trees at 150
# nodes, each production emits at most two instructions) exceeds the
# largest.  The port needs no padding, but keeps the largest class as the
# bound of a program and the size of LevelState's ω buffer.
PAD_CLASSES = (64, 160, 320)


class Program(NamedTuple):
    opcodes: np.ndarray  # int32[length]
    # float32[length], or [B, length] for B members; or a float32 tensor
    # on the device
    omegas: np.ndarray
    length: int


def batched_program(programs) -> Program:
    """Same-structure programs as one program with a member per row of ω."""
    first = programs[0]
    return Program(first.opcodes, np.stack([np.asarray(p.omegas[:p.length], dtype=np.float32)
                                            for p in programs]), first.length)


def _omega_at(omegas: torch.Tensor, i: int, like: torch.Tensor) -> torch.Tensor:
    """Instruction i's ω: a 0-d view, or per member viewed to scale fields
    shaped like `like`."""
    if omegas.dim() == 1:
        return omegas[i]
    return sops.per_member(omegas[:, i], like)


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
        # Per opcode the eager branch, branch(state, ω) -> state, and the
        # interpreter's body, body(LevelState) (None for NOP: no graph).
        self._branches = [self._nop_branch()]
        self._bodies = [None]
        self.isa_version = 0
        self.last_failure = None  # "not_translatable" | "pad_overflow"
        # Lazy registration may come from concurrent evaluations
        # (parallel/dispatch.py): without the lock two threads could bind
        # an opcode key to another op's branch index.
        self._op_lock = threading.Lock()
        self._preregister()

    # ------------------------------------------------------------------
    # ISA construction
    # ------------------------------------------------------------------

    def _nop_branch(self):
        def nop(state, omega):
            return state

        return nop

    def _opcode(self, key, make_branch) -> int:
        """The opcode of `key`, registered on first sight: make_branch()
        returns (branch, body)."""
        idx = self._op_index.get(key)
        if idx is not None:
            return idx
        with self._op_lock:
            idx = self._op_index.get(key)
            if idx is not None:
                return idx
            branch, body = make_branch()
            idx = len(self._branches)
            self._branches.append(branch)
            self._bodies.append(body)
            self._op_index[key] = idx
            self.isa_version += 1
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

            return branch, _writing_level(branch, level, reads_omega=True)

        return self._opcode(key, make)

    def _restrict_opcode(self, R, A, level: int) -> int:
        key = ("restrict", level, canonical_string(R), canonical_string(A))
        lowering = self.lowering
        coarse_shapes = self._shapes[level + 1]

        def make():
            def restricted(u, f):
                r = sops.tree_sub(f[level], lowering.system_apply(A, u[level]))
                return lowering.intergrid_apply(R, r)

            def branch(state, omega):
                u, f = state
                members = sops.member_shape(u[level][0], len(coarse_shapes[0]))
                u_c = tuple(
                    torch.zeros(members + lowering.local_shape(s), dtype=lowering.dtype,
                                device=lowering.device)
                    for s in coarse_shapes
                )
                return (_replace(u, level + 1, u_c), _replace(f, level + 1, restricted(u, f)))

            def body(state):
                _write(state.f_all[level + 1], restricted(state.u_all, state.f_all))
                for x in state.u_all[level + 1]:
                    x.zero_()

            return branch, body

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

            return branch, _writing_level(branch, level, reads_omega=True)

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

            return branch, _writing_level(branch, level, reads_omega=False)

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
        """Program for `expression`, or None if outside the ISA or longer
        than the largest pad class (`last_failure` says which)."""
        instrs: List[Tuple[int, float]] = []
        self.last_failure = None
        try:
            self._emit(expression, instrs)
        except _NotTranslatable:
            instrs = []
        if not instrs:
            self.last_failure = "not_translatable"
            return None
        if len(instrs) > PAD_CLASSES[-1]:
            self.last_failure = "pad_overflow"
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
        level, with the same call shape as the lowered step: the eager form
        of the interpreter.  Instruction i reads ω as the 0-d view
        omegas[i] of `device_omegas(program)`; a numpy ω vector costs one
        host-to-device copy per call, so a caller that runs the step many
        times passes a program whose ω is a device tensor."""
        branches = self._branches
        shapes = self._shapes
        lowering = self.lowering

        def zeros(level, members):
            return tuple(
                torch.zeros(members + lowering.local_shape(s), dtype=lowering.dtype,
                            device=lowering.device)
                for s in shapes[level]
            )

        def step(u: Tuple, f: Tuple, program: Program) -> Tuple:
            members = sops.member_shape(u[0], len(shapes[0][0]))
            u_all = (tuple(u),) + tuple(zeros(i, members) for i in range(1, len(shapes)))
            f_all = (tuple(f),) + tuple(zeros(i, members) for i in range(1, len(shapes)))
            state = (u_all, f_all)
            omegas = device_omegas(program, lowering.device)
            for i, op in enumerate(program.opcodes[:program.length].tolist()):
                state = branches[op](state, _omega_at(omegas, i, u[0]))
            return state[0][0]

        step.layout = lowering.layout
        # The generator runs the interpreter of this VM in its place on
        # CUDA graphs (backend/evaluation.py).
        step.vm = self
        return step

    def make_state(self, members: Optional[int] = None) -> "LevelState":
        return LevelState(self, members)


def _write(dst: Tuple, src: Tuple) -> None:
    """Copy a branch's result into the static state.  The result is a new
    tensor the branch computed to the end, so no operand is overwritten
    while it is still read."""
    for d, x in zip(dst, src):
        d.copy_(x)


def _writing_level(branch, level: int, reads_omega: bool):
    """The body of a branch that changes only u_level: the branch on the
    static state, its u_level copied back."""

    def body(state):
        omega = state.omega() if reads_omega else None
        _write(state.u_all[level], branch((state.u_all, state.f_all), omega)[0][level])

    return body


class LevelState:
    """The interpreter's static state for one VM: every level's iterate and
    right-hand side (`u_all`, `f_all`, one tuple of fields per level, 0 the
    finest, in the lowering's local shapes), the program counter `pc` (0-d
    int64) and the ω buffer (float32, PAD_CLASSES[-1] entries), all
    allocated once.  A caller writes the finest level (`u`, `f`) and loads
    a program's ω; `prologue` and `body(opcode)` are what
    backend/graphs.Interpreter captures.  With `members` = B every level is
    shaped (B, *local) and the ω buffer (B, PAD_CLASSES[-1]), one row per
    member, for a batch of same-structure programs."""

    def __init__(self, vm: CycleVM, members: Optional[int] = None):
        self.vm = vm
        self.members = members
        lowering = vm.lowering
        lead = () if members is None else (members,)

        def level(shapes):
            return tuple(torch.zeros(lead + lowering.local_shape(s), dtype=lowering.dtype,
                                     device=lowering.device) for s in shapes)

        self.u_all = tuple(level(shapes) for shapes in vm._shapes)
        self.f_all = tuple(level(shapes) for shapes in vm._shapes)
        self.u, self.f = self.u_all[0], self.f_all[0]
        self.pc = torch.zeros((), dtype=torch.int64, device=lowering.device)
        self.omegas = torch.ones(lead + (PAD_CLASSES[-1],), dtype=torch.float32,
                                 device=lowering.device)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return sum(self.u_all, ()) + sum(self.f_all, ()) + (self.pc, self.omegas)

    def load(self, program: Program) -> List[int]:
        """Copy the program's ω (a numpy vector, as `translate` makes it,
        or one row per member, as `batched_program` makes it) into the
        buffer; returns its opcodes."""
        n = program.length
        self.omegas[..., :n].copy_(torch.from_numpy(
            np.ascontiguousarray(program.omegas[..., :n], dtype=np.float32)))
        return program.opcodes[:n].tolist()

    def omega(self) -> torch.Tensor:
        """The current instruction's ω, omegas[pc], read on the device
        (indexing with the 0-d `pc` itself would read it to the host); with
        members one per member, viewed to scale the members' fields."""
        if self.members is None:
            return self.omegas.index_select(0, self.pc.view(1)).view(())
        return sops.per_member(self.omegas.index_select(1, self.pc.view(1)), self.u[0])

    def prologue(self) -> None:
        """pc = 0 and the coarse levels zeroed, as `make_step` starts."""
        self.pc.zero_()
        for level in self.u_all[1:] + self.f_all[1:]:
            for x in level:
                x.zero_()

    def body(self, opcode: int):
        """One instruction: the branch's body, then pc + 1."""
        body = self.vm._bodies[opcode]

        def run():
            body(self)
            self.pc.add_(1)

        return run
