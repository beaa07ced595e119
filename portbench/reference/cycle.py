"""A multigrid cycle read from its grammar tree string, run in plain PyTorch.

The string nests productions, the innermost first applied:

  u_and_f                                the iterate u and right-hand side f
  residual_d(S)                          pending correction f - A·u at depth d
  collective_jacobi_d(rf_i, P, C)        u += ω·D⁻¹(f - A·u); P = single, or
                                         red_black: red nodes (i + j even)
                                         first, then black against the
                                         updated iterate
  collective_block_jacobi_d(rf_i, bs_AxB, C)
                                         u += ω·B⁻¹(f - A·u), B the operator
                                         on A×B blocks (hierarchy.py)
  coarsening_d(A_c, zero_c, R_d, C)      a coarse state (0, R·(f - A·u)) at
                                         depth d + 1 under the fine one
  update_with_coarse_grid_correction_d(rf_i, P_c, S)
                                         the coarse state's iterate e leaves:
                                         u += ω·P·e at depth d
  correct_with_coarse_grid_solver_d(rf_i, P_c, CGS_c, R_d, C)
                                         u += ω·P·A_c⁻¹·R·(f - A·u)

Depth d is the level max_level - d; `rf_i` is ω = 0.1 + 0.05·i.  A name may
carry a `__n` suffix (the guarded twin of a production): it means the same.
Stored ω replace the string's factors slot by slot, the slots numbered in
the order their updates complete (the innermost first).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import torch

from portbench.reference.hierarchy import (
    Level, assemble, block_jacobi_correction, prolong, red_black_masks, restrict)

_TOKEN = re.compile(r"[A-Za-z0-9_.]+|[(),]")
_SUFFIX = re.compile(r"__\d+$")
_DEPTH = re.compile(r"^(.*)_(\d+)$")


def omega_of(index_name: str) -> float:
    return 0.1 + 0.05 * int(index_name[len("rf_"):])


def parse(text: str):
    """Nested (name, [args]) terms; a terminal is (name, [])."""
    tokens = _TOKEN.findall(text)
    pos = 0

    def term():
        nonlocal pos
        name = tokens[pos]
        pos += 1
        args = []
        if pos < len(tokens) and tokens[pos] == "(":
            pos += 1
            while True:
                args.append(term())
                sep = tokens[pos]
                pos += 1
                if sep == ")":
                    break
        return name, args

    tree = term()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens after the tree: {tokens[pos:pos + 5]}")
    return tree


def _production(name: str):
    """(production, depth) of a production name; (name, None) for a
    terminal without a depth."""
    base = _SUFFIX.sub("", name)
    match = _DEPTH.match(base)
    if match is None or base.startswith("rf_") or base.startswith("bs_"):
        return base, None
    return match.group(1), int(match.group(2))


class Instruction:
    __slots__ = ("op", "depth", "omega_index", "partitioning", "block", "omega")

    def __init__(self, op, depth, omega_index=None, partitioning=None, block=None):
        self.op, self.depth, self.omega_index = op, depth, omega_index
        self.partitioning, self.block = partitioning, block


def compile_tree(tree) -> List[Instruction]:
    """The tree as a list of instructions in the order they run."""
    program: List[Instruction] = []

    def emit(node):
        name, args = node
        production, depth = _production(name)
        if production == "u_and_f":
            program.append(Instruction("start", 0))
            return
        if not args:
            raise ValueError(f"unexpected terminal {name} where a state belongs")
        emit(args[-1])
        if production == "residual":
            return
        if production == "collective_jacobi":
            program.append(Instruction("jacobi", depth, args[0][0],
                                       partitioning=_SUFFIX.sub("", args[1][0])))
        elif production == "collective_block_jacobi":
            shape = tuple(int(x) for x in args[1][0][len("bs_"):].split("x"))
            program.append(Instruction("block_jacobi", depth, args[0][0], block=shape))
        elif production == "coarsening":
            program.append(Instruction("coarsen", depth))
        elif production == "update_with_coarse_grid_correction":
            program.append(Instruction("correct", depth, args[0][0]))
        elif production == "correct_with_coarse_grid_solver":
            program.append(Instruction("solve", depth, args[0][0]))
        else:
            raise ValueError(f"unknown production {name}")

    emit(tree)
    return program


class Cycle:
    """cycle(u, f) -> u': one application of the tree's cycle at the
    finest level of a hierarchy whose finest level is `max_level`.

    `shift_k2` shifts every level's operator by -shift_k2 (Helmholtz:
    shift·k²).  `omegas`: stored factors, one per slot; when their count
    differs from the tree's slots the string's own factors stay."""

    def __init__(self, text: str, max_level: int, shift_k2: complex = 0.0,
                 omegas: Optional[Sequence[float]] = None, dtype=torch.float64,
                 device="cpu"):
        self.program = compile_tree(parse(text))
        self.dtype, self.device = dtype, torch.device(device)
        slots = [ins for ins in self.program if ins.omega_index is not None]
        self.omegas_applied = omegas is not None and len(omegas) == len(slots)
        for k, ins in enumerate(slots):
            ins.omega = float(omegas[k]) if self.omegas_applied else omega_of(ins.omega_index)
        self.max_level = max_level
        depths = max(ins.depth for ins in self.program) + 2
        self.levels = [Level(max_level - d, shift_k2) for d in range(depths)]
        self._masks = {}
        self._coarse = {}

    @property
    def slots(self) -> int:
        return sum(1 for ins in self.program if ins.omega_index is not None)

    def _rb_masks(self, level: Level):
        if level.n not in self._masks:
            self._masks[level.n] = red_black_masks(level.n, self.dtype, self.device)
        return self._masks[level.n]

    def _coarse_solve(self, depth: int, r: torch.Tensor) -> torch.Tensor:
        """A_c⁻¹·r by a dense inverse, formed in 64-bit arithmetic and held
        in the cycle's dtype."""
        if depth not in self._coarse:
            wide = torch.complex128 if self.dtype.is_complex else torch.float64
            inverse = torch.linalg.inv(assemble(self.levels[depth], wide, self.device))
            self._coarse[depth] = inverse.to(self.dtype)
        n = self.levels[depth].n
        return (self._coarse[depth] @ r.reshape(n * n, 1)).reshape(n, n)

    def _smooth(self, ins, u, f):
        level = self.levels[ins.depth]
        omega = ins.omega
        if ins.op == "block_jacobi":
            return u + omega * block_jacobi_correction(level, level.residual(u, f), ins.block)
        inv_centre = 1.0 / level.centre
        if ins.partitioning == "single":
            return u + (omega * inv_centre) * level.residual(u, f)
        if ins.partitioning != "red_black":
            raise ValueError(f"unknown partitioning {ins.partitioning}")
        for mask in self._rb_masks(level):
            u = u + (omega * inv_centre) * (mask * level.residual(u, f))
        return u

    def __call__(self, u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        stack = []
        for ins in self.program:
            op = ins.op
            if op == "start":
                stack.append([u, f])
            elif op in ("jacobi", "block_jacobi"):
                top = stack[-1]
                top[0] = self._smooth(ins, top[0], top[1])
            elif op == "coarsen":
                fine_u, fine_f = stack[-1]
                rc = restrict(self.levels[ins.depth].residual(fine_u, fine_f))
                stack.append([torch.zeros_like(rc), rc])
            elif op == "correct":
                coarse_u, _ = stack.pop()
                top = stack[-1]
                top[0] = top[0] + ins.omega * prolong(coarse_u)
            elif op == "solve":
                top = stack[-1]
                rc = restrict(self.levels[ins.depth].residual(top[0], top[1]))
                top[0] = top[0] + ins.omega * prolong(self._coarse_solve(ins.depth + 1, rc))
        if len(stack) != 1:
            raise ValueError(f"the tree leaves {len(stack)} states, not one")
        return stack[0][0]
