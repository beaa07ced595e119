"""Parser for ExaSlang-flavour problem specifications (counterpart of
evostencils_tpu/problems/parser.py).

The same surface, regexes and rules as the reference's parser, so one spec
text parses to the same `Problem` in both packages: fields, stencil
operators (with vf_gridWidth_* resolved per level via sympy), equations,
Globals constants, the level range, the outer solver of a layer-3 config
and the Solve protocol of a layer-4 FAS template.  Only the array side
differs: default dtypes are torch dtypes (torch.float32, and torch.complex64
for `Complex<Real>` fields), and the FAS template's nonlinear operator
works on torch tensors through the port's ops/stencil_ops.

Three entry points, one per ExaSlang layer:
  * `parse_exa2` — layer-2 specs (Poisson 2D/3D, LinearElasticity):
      `<name> with <T> on Node of global [= expr]`   field declaration
      `RHS_<field> with ... = expr`                  right-hand side
      `<name> from Stencil { [o, o] => expr ... }`   stencil operator
      `<name> from default restriction|prolongation on Node with 'linear'`
      `<eqname> { lhs == rhs }`                      equation
      `Globals { Expr <name> = value }`              constants
  * `parse_exa3` — layer-3 configs (2D_FD_Helmholtz_fromL3.exa3):
      adds `Field x@level with Complex<Real> ...`, complex Globals
      (`Expr shift = (1.0 + 0.5j)`), `Equation name { lhs == rhs }`
      blocks, `Operator ... from Stencil` with parameter symbols (k,
      shift — wired to the Problem parameter ladder), and outer-solver
      extraction from the hand-written `PreconditionedBiCGStab` function
      (target reduction + iteration cap + outer operator A).
  * `parse_exa4` — layer-4 FAS templates (FAS_2D_Basic_template.exa4):
      two-slot fields (`Field Solution<...>[2]`), nonlinear stencils
      whose coefficients reference the solution (`gamSten`: γ·exp(u)),
      analytic-Jacobian extraction via sympy.diff, manufactured
      rhsFct/solFct functions, and the Solve protocol (target/cap).
  * .knowledge: dimensionality / minLevel / maxLevel (`parse_knowledge`)
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

import numpy as np
import sympy
import torch

from evostencils_torch.ir import base
from evostencils_torch.problems.api import Problem
from evostencils_torch.stencils import constant, gallery

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)
_STENCIL_BLOCK = re.compile(
    r"(\w+)\s+from\s+Stencil\s*\{(.*?)\}", re.DOTALL
)
_STENCIL_ENTRY = re.compile(r"\[([^\]]+)\]\s*=>\s*([^\n]+)")
_DEFAULT_OP = re.compile(
    r"(\w+)(?:@\w+)?\s+from\s+default\s+(restriction|prolongation)\s+on\s+Node"
)
_EQUATION_BLOCK = re.compile(r"(\w+)\s*\{([^{}]*?==[^{}]*?)\}", re.DOTALL)
_GLOBALS_BLOCK = re.compile(r"Globals\s*\{(.*?)\}", re.DOTALL)
_GLOBAL_ENTRY = re.compile(r"(?:Expr|Val)\s+(\w+)\s*(?::\s*\w+\s*)?=\s*([^\n]+)")
_FIELD_DECL = re.compile(r"(\w+)\s+with\s+(\w+(?:<\w+>)?)\s+on\s+Node\s+of\s+\w+(?:\s*=\s*([^\n]+))?")
_KNOWLEDGE_ENTRY = re.compile(r"(\w+)\s*=\s*([^\n/]+)")


class ParsedStencilGenerator(gallery.StencilGenerator):
    """Stencil whose coefficient expressions reference vf_gridWidth_*."""

    _WIDTH_SYMBOLS = [
        sympy.Symbol(f"vf_gridWidth_{axis}") for axis in ("x", "y", "z")
    ]

    def __init__(self, entries, constants: Dict[str, float]):
        # entries: list of (offset tuple, sympy expr string)
        self._raw_entries = entries
        self._constants = constants
        # Stencil per grid: an eager cycle asks for its operators on every
        # call, and sympy takes milliseconds per entry.
        self._stencils = {}

    def generate_stencil(self, grid):
        stencil = self._stencils.get(grid)
        if stencil is None:
            stencil = self._stencils[grid] = self._evaluate(grid)
        return stencil

    def _evaluate(self, grid):
        subs = {sympy.Symbol(k): v for k, v in self._constants.items()}
        subs[sympy.Symbol("PI")] = math.pi
        for axis in range(grid.dimension):
            subs[self._WIDTH_SYMBOLS[axis]] = grid.spacing[axis]
        out = []
        for offset, expr in self._raw_entries:
            value = sympy.sympify(expr, locals={"PI": sympy.pi}).subs(subs)
            out.append((offset, complex(value) if value.has(sympy.I) else float(value)))
        return constant.Stencil(out)


def _strip_comments(text: str) -> str:
    return _COMMENT.sub("", text)


def _sympy_rhs_to_callable(expr_str: str):
    """Compile an RHS expression over vf_nodePos_* to a numpy callable.

    Also supports `vf_gridWidth_*` (resolved from the coordinate arrays:
    the grids are uniform, so the spacing is the first coordinate delta
    along the axis), `max` and `fabs` (the Helmholtz Dirac-pulse RHS,
    2D_FD_Helmholtz_fromL3.exa3)."""
    expr_str = expr_str.strip()
    if expr_str in ("0.0", "0"):
        return None
    pos = [sympy.Symbol(f"vf_nodePos_{a}") for a in ("x", "y", "z")]
    width = [sympy.Symbol(f"vf_gridWidth_{a}") for a in ("x", "y", "z")]
    expr = sympy.sympify(
        expr_str,
        locals={"PI": sympy.pi, "max": sympy.Max, "fabs": sympy.Abs},
    )
    used = [s for s in pos if s in expr.free_symbols]
    dims = max(
        (pos.index(s) + 1 for s in used),
        default=max(
            (width.index(s) + 1 for s in width if s in expr.free_symbols),
            default=2,
        ),
    )
    args = pos[:dims] + [w for w in width[:dims] if w in expr.free_symbols]
    fn = sympy.lambdify(
        args, expr,
        modules=[{"Max": np.maximum, "Abs": np.abs, "max": np.maximum,
                  "fabs": np.abs}, "numpy"],
    )

    def call(*coords):
        extra = []
        for w in width[:dims]:
            if w in expr.free_symbols:
                axis = width.index(w)
                c = coords[axis]
                h = float(np.take(c, 1, axis=axis).flat[0]
                          - np.take(c, 0, axis=axis).flat[0]) if c.shape[axis] > 1 \
                    else float(c.flat[0])
                extra.append(h)
        out = fn(*coords[:dims], *extra)
        return np.broadcast_to(out, coords[0].shape).astype(float)

    return call


def parse_knowledge(path: str) -> Dict[str, str]:
    values = {}
    with open(path) as f:
        text = _strip_comments(f.read())
    for line in text.splitlines():
        m = _KNOWLEDGE_ENTRY.match(line.strip())
        if m:
            values[m.group(1)] = m.group(2).strip().strip('"')
    return values


def parse_exa2(
    path: str,
    knowledge_path: Optional[str] = None,
    dtype=None,
    name: Optional[str] = None,
) -> Problem:
    with open(path) as f:
        text = _strip_comments(f.read())

    knowledge = parse_knowledge(knowledge_path) if knowledge_path else {}
    dimension = int(knowledge.get("dimensionality", 2))
    min_level = int(knowledge.get("minLevel", 5))
    max_level = int(knowledge.get("maxLevel", 9))

    # `lambda` is a Python keyword, which sympy's parser rejects —
    # rename the symbol throughout (the elasticity spec uses it).
    text = re.sub(r"\blambda\b", "lam_", text)

    # Globals -> constants
    constants: Dict[str, float] = {}
    for block in _GLOBALS_BLOCK.findall(text):
        for cname, cvalue in _GLOBAL_ENTRY.findall(block):
            constants[cname] = float(sympy.sympify(cvalue))

    # Stencil operators
    operator_factories = {}
    for op_name, body in _STENCIL_BLOCK.findall(text):
        entries = []
        for offsets_str, expr in _STENCIL_ENTRY.findall(body):
            offset = tuple(int(x) for x in offsets_str.split(","))
            entries.append((offset, expr.strip()))
        operator_factories[op_name] = (
            (lambda level, params, e=tuple(entries): ParsedStencilGenerator(e, constants)),
            base.Operator,
        )

    # Fields + RHS expressions (declaration order defines field order)
    fields: List[str] = []
    rhs_for: Dict[str, Optional[str]] = {}
    boundary_for: Dict[str, str] = {}
    for fname, ftype, init in _FIELD_DECL.findall(text):
        if fname.startswith("RHS"):
            continue
        if fname not in fields:
            fields.append(fname)
    for m in re.finditer(r"(RHS_?\w*)\s+with\s+\w+(?:<\w+>)?\s+on\s+Node\s+of\s+\w+\s*=\s*([^\n]+)", text):
        rhs_for[m.group(1)] = m.group(2).strip()

    # Equations (skip Globals / stencil blocks already matched)
    stencil_names = set(operator_factories)
    equation_strings = []
    rhs_order: List[Optional[str]] = []
    for eq_name, body in _EQUATION_BLOCK.findall(text):
        if eq_name in ("Globals",) or eq_name in stencil_names:
            continue
        body = " ".join(body.split())
        if "==" not in body:
            continue
        lhs, rhs_name = body.split("==")
        rhs_name = rhs_name.strip()
        equation_strings.append((eq_name, f"{lhs.strip()} == {rhs_name}"))
        rhs_order.append(rhs_name)

    # Default intergrid operators per field.  The .exa2 grammar only ever
    # declares `default restriction/prolongation ... with 'linear'` (no
    # custom stencil bodies exist in the format), so full-weighting /
    # multilinear generators are synthesized unconditionally — exactly the
    # operators ExaStencils' generate-solver emits for those declarations
    # (parity-tested in tests/test_aux.py).  Custom-named transfer
    # operators are an .exa3 feature, handled by parse_exa3.
    cf = (2,) * dimension
    for i, field in enumerate(fields):
        operator_factories[f"gen_restriction_{field}"] = (
            (lambda level, params: gallery.FullWeightingRestrictionGenerator(cf)),
            base.Restriction,
        )
        operator_factories[f"gen_prolongation_{field}"] = (
            (lambda level, params: gallery.MultilinearInterpolationGenerator(cf)),
            base.Prolongation,
        )

    rhs_functions = []
    for rhs_name in rhs_order:
        rhs_functions.append(_sympy_rhs_to_callable(rhs_for.get(rhs_name, "0.0") or "0.0"))

    return Problem(
        name=name or path.rsplit("/", 1)[-1].split(".")[0],
        dimension=dimension,
        min_level=min_level,
        max_level=max_level,
        fields=fields,
        equation_strings=equation_strings,
        operator_factories=operator_factories,
        rhs_functions=rhs_functions if any(r is not None for r in rhs_functions) else None,
        dtype=dtype if dtype is not None else torch.float32,
        constants=constants,
    )


# ---------------------------------------------------------------------------
# Layer 3: Helmholtz-style configs (reference 2D_FD_Helmholtz_fromL3.exa3)
# ---------------------------------------------------------------------------

_EQUATION_EXA3 = re.compile(r"Equation\s+(\w+)\s*\{([^{}]*?)\}", re.DOTALL)
_FIELD_EXA3 = re.compile(
    r"Field\s+(\w+)(?:@\w+)?\s+with\s+([\w<>]+)\s+on\s+Node\s+of\s+\w+"
    r"(?:\s*=\s*([^\n]+))?"
)
_REPEAT_TIMES = re.compile(r"repeat\s+(\d+)\s+times")
_TARGET_TEST = re.compile(
    r"fabs\s*\(\s*curRes\s*\)\s*<\s*([0-9.eE+-]+)\s*\*\s*fabs\s*\(\s*initRes\s*\)"
)


def _parse_const(value: str):
    """Numeric Globals value: float, or Python complex (`(1.0 + 0.5j)`)."""
    value = value.strip()
    try:
        return float(sympy.sympify(value))
    except (TypeError, ValueError, sympy.SympifyError):
        return complex(value.replace(" ", "").strip("()"))


def _function_body(text: str, name: str) -> Optional[str]:
    """Balanced-brace body of `Function <name>[@...] ... { ... }`."""
    m = re.search(rf"Function\s+{name}\b[^{{]*\{{", text)
    if m is None:
        return None
    depth = 1
    i = m.end()
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return text[m.end():i - 1]


def parse_exa3(
    path: str,
    knowledge_path: Optional[str] = None,
    dtype=None,
    name: Optional[str] = None,
) -> Problem:
    """Load a layer-3 config (Operator/Globals/Equation/Function surface).

    The reference's Helmholtz config declares two stencil operators: M
    (the shifted-Laplace preconditioner, bound by `Equation PrecEq`) and
    A (the outer Helmholtz operator driven by the hand-written
    `PreconditionedBiCGStab`); parameter symbols in stencil coefficients
    (k, shift) resolve from Globals and are overridable through the
    Problem parameter ladder (reference scripts/optimize.py:34-37)."""
    with open(path) as f:
        text = _strip_comments(f.read())

    knowledge = parse_knowledge(knowledge_path) if knowledge_path else {}
    dimension = int(knowledge.get("dimensionality", 2))
    min_level = int(knowledge.get("minLevel", 3))
    max_level = int(knowledge.get("maxLevel", 7))

    constants: Dict[str, float] = {}
    for block in _GLOBALS_BLOCK.findall(text):
        for cname, cvalue in _GLOBAL_ENTRY.findall(block):
            constants[cname] = _parse_const(cvalue)

    # Complex<Real> fields -> complex64 problem dtype.
    is_complex = "Complex<Real>" in text

    stencil_ops: Dict[str, list] = {}
    for op_name, body in _STENCIL_BLOCK.findall(text):
        entries = []
        for offsets_str, expr in _STENCIL_ENTRY.findall(body):
            offset = tuple(int(x) for x in offsets_str.split(","))
            entries.append((offset, expr.strip()))
        stencil_ops[op_name] = entries

    equation_strings = []
    equation_operators = set()
    unknowns: List[str] = []
    rhs_names: List[str] = []
    field_names = {m.group(1) for m in _FIELD_EXA3.finditer(text)}
    for eq_name, body in _EQUATION_EXA3.findall(text):
        body = " ".join(body.split())
        lhs, rhs_name = body.split("==")
        lhs, rhs_name = lhs.strip(), rhs_name.strip()
        symbols = set(re.findall(r"\b\w+\b", lhs))
        equation_operators |= symbols & set(stencil_ops)
        for sym in symbols:
            if sym in field_names and sym not in unknowns:
                unknowns.append(sym)
        equation_strings.append((eq_name, f"{lhs} == {rhs_name}"))
        rhs_names.append(rhs_name)

    operator_factories = {}
    for op_name in equation_operators:
        entries = tuple(stencil_ops[op_name])

        def factory(level, params, e=entries):
            return ParsedStencilGenerator(
                list(e), {**constants, **{
                    k: v for k, v in params.items()
                    if isinstance(v, (int, float, complex))
                }}
            )

        operator_factories[op_name] = (factory, base.Operator)
    cf = (2,) * dimension
    for kind_name, kind in _DEFAULT_OP.findall(text):
        if kind == "restriction":
            operator_factories[kind_name] = (
                (lambda level, params: gallery.FullWeightingRestrictionGenerator(cf)),
                base.Restriction,
            )
        else:
            operator_factories[kind_name] = (
                (lambda level, params: gallery.MultilinearInterpolationGenerator(cf)),
                base.Prolongation,
            )

    # The finest-level right-hand side: the `RHS@finest` field initializer
    # (name-convention binding, reference parser.py:86-96).
    rhs_expr = None
    for m in _FIELD_EXA3.finditer(text):
        if m.group(1) == "RHS" and m.group(3):
            rhs_expr = m.group(3).strip()
            break
    rhs_fn = _sympy_rhs_to_callable(rhs_expr) if rhs_expr else None

    # Outer solver: the hand-written preconditioned Krylov solve.
    outer_solver = None
    outer_body = _function_body(text, "PreconditionedBiCGStab")
    if outer_body is not None:
        target = 1e-7
        m = _TARGET_TEST.search(outer_body)
        if m:
            target = float(m.group(1))
        cap = 10000
        m = _REPEAT_TIMES.search(outer_body)
        if m:
            cap = int(m.group(1))
        outer_names = [
            op for op in stencil_ops if op not in equation_operators
        ]
        if outer_names:
            outer_entries = tuple(stencil_ops[outer_names[0]])

            def outer_factory(level, params, e=outer_entries):
                return ParsedStencilGenerator(
                    list(e), {**constants, **{
                        k: v for k, v in params.items()
                        if isinstance(v, (int, float, complex))
                    }}
                )

            outer_solver = {
                "type": "preconditioned_bicgstab",
                "operator_factory": outer_factory,
                "target_reduction": target,
                "max_iterations": cap,
            }

    parameters = {
        k: v for k, v in constants.items()
        if isinstance(v, (int, float, complex)) and k not in ("omegaRelax",)
    }
    return Problem(
        name=name or path.rsplit("/", 1)[-1].split(".")[0],
        dimension=dimension,
        min_level=min_level,
        max_level=max_level,
        fields=unknowns,
        equation_strings=equation_strings,
        operator_factories=operator_factories,
        rhs_functions=[rhs_fn] * len(unknowns) if rhs_fn else None,
        dtype=dtype if dtype is not None else (
            torch.complex64 if is_complex else torch.float32
        ),
        parameters=parameters,
        constants=constants,
        outer_solver=outer_solver,
        residual_target=(outer_solver or {}).get("target_reduction", 1e-12),
        iteration_limit=(outer_solver or {}).get("max_iterations", 500),
    )


# ---------------------------------------------------------------------------
# Layer 4: FAS nonlinear templates (reference FAS_2D_Basic_template.exa4)
# ---------------------------------------------------------------------------

_STENCIL_EXA4 = re.compile(r"Stencil\s+(\w+)(?:@\w+)?\s*\{(.*?)\}", re.DOTALL)
_FIELD_EXA4 = re.compile(r"Field\s+(\w+)\s*<[^>]*>\s*(\[\d+\])?")
_SOLVE_PROTOCOL = re.compile(
    r"repeat\s+until\s*\(\s*\w+\s*<\s*\(\s*([0-9.eE+-]+)\s*\*\s*\w+\s*\)"
    r"\s*\|\|\s*\w+\s*>=\s*(\d+)\s*\)"
)
_LEVEL_TOKEN = re.compile(r"@\w+|<active>|<next>|@current")
# The functions a nonlinear coefficient may use, on torch tensors.
_TORCH_FUNCTIONS = {"exp": torch.exp}


class ParsedNonlinearGenerator:
    """Nonlinear operator A(u) = L·u + c(u)·u from parsed exa4 stencils.

    L is the linear stencil (e.g. Laplace); c(u) the solution-dependent
    coefficient of the nonlinear stencil (e.g. gamSten = γ·exp(u)).  The
    Jacobian diagonal d/du [c(u)·u] is derived symbolically — exactly the
    reference's sympy.diff extraction (exastencils_FAS.py:52-55).
    Implements the port's nonlinear-operator protocol (problems/fas.py,
    backend/lowering.py) on torch tensors:
    `apply`, `nonlinear_term`, `derivative_diag`, `linear_center`, plus
    `generate_stencil` = the linearization at u = 0 for stencil-algebra
    passes (diagonal splits, LFA at the linearized state)."""

    is_nonlinear = True

    def __init__(self, linear_generator, coeff_expr: str,
                 constants: Dict[str, float], field_name: str):
        self._linear = linear_generator
        self._constants = constants
        u = sympy.Symbol("_u_")
        expr = sympy.sympify(
            re.sub(rf"\b{field_name}\b", "_u_", coeff_expr),
            locals={"PI": sympy.pi, "exp": sympy.exp},
        ).subs({sympy.Symbol(k): v for k, v in constants.items()})
        self._term_expr = expr * u
        self._deriv_expr = sympy.diff(self._term_expr, u)
        self._term_fn = None
        self._deriv_fn = None
        self._u_symbol = u

    def is_variable(self):
        return False

    def _callables(self):
        if self._term_fn is None:
            # An explicit module dict, not sympy's "torch" printer, whose
            # presence depends on the installed sympy.
            self._term_fn = sympy.lambdify(
                self._u_symbol, self._term_expr, modules=[_TORCH_FUNCTIONS]
            )
            self._deriv_fn = sympy.lambdify(
                self._u_symbol, self._deriv_expr, modules=[_TORCH_FUNCTIONS]
            )
        return self._term_fn, self._deriv_fn

    def generate_stencil(self, grid):
        d0 = float(self._deriv_expr.subs(self._u_symbol, 0))
        return constant.add(
            self._linear.generate_stencil(grid),
            constant.Stencil([((0,) * grid.dimension, d0)]),
        )

    # ---- nonlinear protocol (backend/lowering.py) ----

    def apply(self, u, grid, slab=None):
        """A(u) on the whole grid, or on this rank's rows of it (`slab`:
        the linear stencil takes its halo rows from the neighbouring ranks;
        the nonlinearity is pointwise)."""
        from evostencils_torch.ops.stencil_ops import apply_stencil

        return (
            apply_stencil(u, self._linear.generate_stencil(grid), slab)
            + self.nonlinear_term(u)
        )

    def nonlinear_term(self, u):
        term_fn, _ = self._callables()
        return term_fn(u)

    def derivative_diag(self, u):
        _, deriv_fn = self._callables()
        return deriv_fn(u)

    def linear_center(self, grid):
        return self._linear.generate_stencil(grid).center_value()


def parse_exa4(
    path: str,
    knowledge_path: Optional[str] = None,
    dtype=None,
    name: Optional[str] = None,
) -> Problem:
    """Load a layer-4 FAS template: two-slot solution fields, a linear
    stencil plus a solution-dependent stencil (combined into one
    nonlinear operator), manufactured rhsFct/solFct functions, default
    transfers, and the Solve protocol (target reduction, iteration cap)."""
    with open(path) as f:
        text = _strip_comments(f.read())

    knowledge = parse_knowledge(knowledge_path) if knowledge_path else {}
    dimension = int(knowledge.get("dimensionality", 2))
    min_level = int(knowledge.get("minLevel", 6))
    max_level = int(knowledge.get("maxLevel", 10))

    constants: Dict[str, float] = {}
    for block in _GLOBALS_BLOCK.findall(text):
        for cname, cvalue in _GLOBAL_ENTRY.findall(block):
            constants[cname] = _parse_const(cvalue)

    # Two-slot fields mark the FAS iterate (reference template: Solution[2]).
    solution_field = None
    for m in _FIELD_EXA4.finditer(text):
        if m.group(2):
            solution_field = m.group(1)
            break
    if solution_field is None:
        raise ValueError(f"{path}: no two-slot field — not a FAS template")

    linear_entries = None
    nonlinear_coeff = None
    for op_name, body in _STENCIL_EXA4.findall(text):
        if "from default" in body:
            continue
        entries = []
        for offsets_str, expr in _STENCIL_ENTRY.findall(body):
            offset = tuple(int(x) for x in offsets_str.split(","))
            entries.append((offset, _LEVEL_TOKEN.sub("", expr).strip()))
        if any(
            re.search(rf"\b{solution_field}\b", expr) for _, expr in entries
        ):
            if len(entries) != 1 or entries[0][0] != (0,) * dimension:
                raise ValueError(
                    f"{path}: nonlinear stencil {op_name} must be a pure "
                    "center-coefficient stencil"
                )
            nonlinear_coeff = entries[0][1]
        else:
            linear_entries = entries
    if linear_entries is None:
        raise ValueError(f"{path}: no linear stencil found")

    linear_gen = ParsedStencilGenerator(linear_entries, constants)
    if nonlinear_coeff is not None:
        def a_factory(level, params):
            merged = {**constants, **{
                k: v for k, v in params.items()
                if isinstance(v, (int, float, complex))
            }}
            return ParsedNonlinearGenerator(
                ParsedStencilGenerator(linear_entries, merged),
                nonlinear_coeff, merged, solution_field,
            )
    else:
        def a_factory(level, params):
            return ParsedStencilGenerator(linear_entries, constants)

    cf = (2,) * dimension
    operator_factories = {
        "A": (a_factory, base.Operator),
        "R": (
            lambda level, params: gallery.FullWeightingRestrictionGenerator(cf),
            base.Restriction,
        ),
        "P": (
            lambda level, params: gallery.MultilinearInterpolationGenerator(cf),
            base.Prolongation,
        ),
    }

    # Manufactured RHS: rhsFct (may reference solFct).
    rhs_fn = None
    rhs_body = _function_body(text, "rhsFct")
    if rhs_body is not None:
        m = re.search(r"return\s*\((.*)\)", rhs_body, re.DOTALL)
        rhs_expr = m.group(1).strip() if m else None
        sol_body = _function_body(text, "solFct")
        if rhs_expr and sol_body:
            ms = re.search(r"return\s*\((.*)\)", sol_body, re.DOTALL)
            if ms:
                rhs_expr = re.sub(
                    r"solFct\s*\(\s*xPos\s*,\s*yPos\s*\)",
                    f"({ms.group(1).strip()})",
                    rhs_expr,
                )
        if rhs_expr:
            x, y = sympy.symbols("xPos yPos")
            expr = sympy.sympify(
                rhs_expr, locals={"PI": sympy.pi, "exp": sympy.exp,
                                  "sin": sympy.sin, "cos": sympy.cos}
            ).subs({sympy.Symbol(k): v for k, v in constants.items()})
            fn = sympy.lambdify((x, y), expr, modules="numpy")

            def rhs_fn(xa, ya, _fn=fn):
                return np.asarray(_fn(xa, ya), dtype=float)

    residual_target = 1e-10
    iteration_limit = 300
    m = _SOLVE_PROTOCOL.search(text)
    if m:
        residual_target = float(m.group(1))
        iteration_limit = int(m.group(2))

    return Problem(
        name=name or path.rsplit("/", 1)[-1].split(".")[0],
        dimension=dimension,
        min_level=min_level,
        max_level=max_level,
        fields=[solution_field],
        equation_strings=[(f"eq_{solution_field}", f"A * {solution_field} == f")],
        operator_factories=operator_factories,
        rhs_functions=[rhs_fn] if rhs_fn else None,
        dtype=dtype if dtype is not None else torch.float32,
        parameters={
            k: v for k, v in constants.items()
            if isinstance(v, (int, float))
        },
        constants=constants,
        uses_fas=nonlinear_coeff is not None,
        residual_target=residual_target,
        iteration_limit=iteration_limit,
    )
