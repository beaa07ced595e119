"""IR analysis passes (reference ir/transformations.py:6-145).

The reference's sympy-based local-system extraction existed to emit
ExaSlang `solve locally` text; the TPU backend instead assembles local
system matrices numerically (ops/smoothers.build_block_solve_spec), so the passes kept here
are the structural ones: iterate lookup, coarsest-level computation,
cache invalidation, and a canonical string used as XLA compile-cache key.
"""

from __future__ import annotations

import itertools

from evostencils_torch.ir import base, system


def obtain_iterate(expression: base.Expression):
    if isinstance(expression, base.BinaryExpression):
        return obtain_iterate(expression.operand2)
    if isinstance(expression, (base.Approximation, system.Approximation)):
        return expression
    return None


def obtain_coarsest_level(cycle: base.Cycle) -> int:
    """Number of distinct coarsenings below the cycle's own grid."""

    def grid_size(expr):
        g = expr.grid
        if isinstance(g, list):
            return tuple(gg.size for gg in g)
        return g.size

    # The tree is a DAG (each Cycle's approximation is shared between its
    # own link and its correction's Residual): without memoization the walk
    # is 2^n in chained smoothing steps, which hangs near the 150-node cap.
    memo = {}

    def descend(expression, current_size, current_level):
        key = (id(expression), current_size, current_level)
        cached = memo.get(key)
        if cached is not None:
            return cached
        result = _descend(expression, current_size, current_level)
        memo[key] = result
        return result

    def _descend(expression, current_size, current_level):
        if isinstance(expression, base.Cycle):
            if grid_size(expression) < current_size:
                new_size, new_level = grid_size(expression), current_level + 1
            else:
                new_size, new_level = current_size, current_level
            return max(
                descend(expression.approximation, new_size, new_level),
                descend(expression.correction, new_size, new_level),
            )
        if isinstance(expression, base.Residual):
            return max(
                descend(expression.approximation, current_size, current_level),
                descend(expression.rhs, current_size, current_level),
            )
        if isinstance(expression, base.BinaryExpression):
            return max(
                descend(expression.operand1, current_size, current_level),
                descend(expression.operand2, current_size, current_level),
            )
        if isinstance(expression, (base.UnaryExpression, base.Scaling)):
            return descend(expression.operand, current_size, current_level)
        if isinstance(expression, (base.Entity, system.System)):
            return current_level
        raise RuntimeError(f"Unexpected expression {type(expression)}")

    return descend(cycle, grid_size(cycle), 0) + 1


def invalidate_expression(expression: base.Expression):
    """Clear analysis caches bottom-up (before pickling checkpoints)."""
    if expression is not None:
        expression.analysis_cache.clear()
        expression.mutate(invalidate_expression)


def collect_cycles(expression) -> list:
    """All Cycle nodes in canonical DFS order (approximation, rhs,
    correction).  Defines the relaxation-factor slot numbering shared by
    `canonical_string(..., parameterize_relaxation=True)` and the
    parameterized lowering."""
    seen = set()
    cycles = []

    def walk(e):
        if e is None or id(e) in seen or not isinstance(e, base.Expression):
            return
        seen.add(id(e))
        if isinstance(e, base.Cycle):
            walk(e.approximation)
            walk(e.rhs)
            walk(e.correction)
            cycles.append(e)
        elif isinstance(e, base.Residual):
            walk(e.operator)
            walk(e.approximation)
            walk(e.rhs)
        elif isinstance(e, base.CoarseGridSolver):
            pass
        elif isinstance(e, base.BinaryExpression):
            walk(e.operand1)
            walk(e.operand2)
        elif isinstance(e, (base.UnaryExpression, base.Scaling)):
            walk(e.operand)

    walk(expression)
    return cycles


_SIGNATURE_CACHE = {}
_GENERATOR_UIDS = itertools.count()


def _entry_signature(entry) -> str:
    """Stable per-process fingerprint of a scalar operator entry's stencil
    content (offsets, values, period) — distinguishes same-named operators
    with different coefficients (block shapes, PDE parameters).

    Content-keyed: caches/keys must never use raw `id(generator)` of
    ephemeral per-compile generators — CPython reuses addresses after GC,
    which aliased fresh block-smoother stencils onto stale signatures.
    """
    gen = getattr(entry, "stencil_generator", None)
    if gen is None:
        return type(entry).__name__
    if getattr(gen, "is_nonlinear", False) or (
        getattr(gen, "is_variable", lambda: False)()
    ):
        # Long-lived problem-level generators: attach a unique id once;
        # the attribute (not the address) is the identity.
        uid = getattr(gen, "_signature_uid", None)
        if uid is None:
            uid = next(_GENERATOR_UIDS)
            try:
                gen._signature_uid = uid
            except AttributeError:
                pass
        return f"g{uid}"
    try:
        stencil = entry.generate_stencil()
    except Exception:
        stencil = None
    if stencil is None:
        return type(entry).__name__
    from evostencils_torch.stencils import periodic as _periodic

    p = _periodic.lift(stencil)
    cached = _SIGNATURE_CACHE.get(p)
    if cached is not None:
        return cached
    parts = [str(p.period)]
    for cell in p.cells.flat:
        if cell is None:
            parts.append("-")
        else:
            parts.append(
                ";".join(f"{o}:{complex(v):.6e}" for o, v in cell.entries)
            )
    sig = f"s{abs(hash('|'.join(parts))):x}"
    _SIGNATURE_CACHE[p] = sig
    return sig


def canonical_string(expression, parameterize_relaxation: bool = False) -> str:
    """Structural fingerprint for compile-cache keys.

    Two cycles with the same canonical string lower to the same jitted
    function (same sequence of kernels / relaxation factors / partitions),
    so sharing it as a cache key eliminates duplicate XLA compilations —
    the TPU analog of the reference's str(tree) fitness cache
    (reference optimization/program.py:188-204).

    The string is emitted in SSA form (one numbered line per distinct DAG
    node, children referenced by id): cycle IRs share subexpressions
    heavily through the approximation chain, so a naive nested expansion
    would be exponentially long in the number of smoothing steps.
    """
    memo = {}
    lines = []

    def _grid_tag(e):
        g = e.grid
        if isinstance(g, list):
            return ",".join(str(gg.level) for gg in g)
        return str(g.level)

    def emit(s: str) -> str:
        name = f"%{len(lines)}"
        lines.append(f"{name}={s}")
        return name

    def walk(e) -> str:
        key = id(e)
        if key in memo:
            return memo[key]
        if isinstance(e, base.Cycle):
            omega = "*" if parameterize_relaxation else e.relaxation_factor
            s = (
                f"Cycle[{omega};{e.partitioning.get_name()}]"
                f"({walk(e.approximation)},{walk(e.rhs)},{walk(e.correction)})"
            )
        elif isinstance(e, base.Residual):
            s = f"Res({walk(e.operator)},{walk(e.approximation)},{walk(e.rhs)})"
        elif isinstance(e, system.Jacobian):
            s = f"Jac[{e.n_newton_steps}]({walk(e.operand)})"
        elif isinstance(e, base.BlockDiagonal):
            s = f"BlockDiag[{e.block_size}]({walk(e.operand)})"
        elif isinstance(e, base.Scaling):
            s = f"Scale[{e.factor}]({walk(e.operand)})"
        elif isinstance(e, base.CoarseGridSolver):
            solver_expr = e.expression
            if solver_expr is not None and not isinstance(solver_expr, base.Expression):
                # Adapter (e.g. NestedCycleSolver) wrapping an inner cycle.
                solver_expr = getattr(solver_expr, "expression", None)
            inner = "" if solver_expr is None else f";{walk(solver_expr)}"
            s = f"CGS({walk(e.operator)}{inner})"
        elif isinstance(e, base.BinaryExpression):
            s = f"{type(e).__name__}({walk(e.operand1)},{walk(e.operand2)})"
        elif isinstance(e, base.UnaryExpression):
            s = f"{type(e).__name__}({walk(e.operand)})"
        elif isinstance(e, system.System):
            # System leaves must fingerprint their entry structure: e.g.
            # block-Jacobi smoothing operators share the *name*
            # "A_0_block_diag" across different block shapes, and Helmholtz
            # k-ladder operators share names across k values — omitting the
            # stencil signatures caused executable-cache collisions.
            if hasattr(e, "entries") and isinstance(e.entries, list):
                try:
                    sig = ",".join(
                        _entry_signature(entry)
                        for row in e.entries
                        for entry in (row if isinstance(row, list) else [row])
                    )
                except Exception:
                    sig = ""
            else:
                sig = ""
            memo[key] = f"{type(e).__name__}[{e.name}@{_grid_tag(e)};{sig}]"
            return memo[key]
        elif isinstance(e, base.Operator):
            memo[key] = (
                f"{type(e).__name__}[{e.name}@{_grid_tag(e)};{_entry_signature(e)}]"
            )
            return memo[key]
        elif isinstance(e, base.Entity):
            memo[key] = f"{type(e).__name__}[{e.name}@{_grid_tag(e)}]"
            return memo[key]
        else:
            s = f"{type(e).__name__}"
        memo[key] = emit(s)
        return memo[key]

    root = walk(expression)
    lines.append(f"ret={root}")
    return ";".join(lines)
