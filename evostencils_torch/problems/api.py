"""Problem specification API (counterpart of evostencils_tpu/problems/api.py).

Same construction as the reference — sympy equations over named operators
with stencil generators — building the port's own copy of the reference's
IR and grammar (`evostencils_torch.ir`, `evostencils_torch.grammar`), so a
grammar tree string and its canonical string mean the same on both.  Only
the array side differs: dtypes are torch (or numpy) dtypes, and states come
back as numpy arrays (``device=None``) or as torch tensors on ``device``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import sympy
import torch

from evostencils_torch import numpy_dtype
from evostencils_torch.grammar import multigrid as mg
from evostencils_torch.ir import base, system


def make_grid(level: int, dimension: int) -> base.Grid:
    n = 2**level
    return base.Grid((n,) * dimension, (1.0 / n,) * dimension, level)


def _to_device(arrays, device):
    if device is None:
        return tuple(arrays)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


class Problem:
    """A PDE problem over a level hierarchy.

    operator_factories: dict name -> (stencil_generator_factory(level,
    params), operator_type); instantiated per level [min_level, max_level].
    equations: list of (name, "lhs == rhs") strings using operator/field
    names.  rhs_functions: per-field callable f(x0, x1, ...) -> numpy array.
    """

    def __init__(
        self,
        name: str,
        dimension: int,
        min_level: int,
        max_level: int,
        fields: Sequence[str],
        equation_strings: Sequence[Tuple[str, str]],
        operator_factories: Dict[str, Tuple[Callable, type]],
        rhs_functions: Optional[Sequence[Callable]] = None,
        dtype=torch.float32,
        parameters: Optional[Dict] = None,
        uses_fas: bool = False,
        constants: Optional[Dict[str, float]] = None,
        outer_solver: Optional[Dict] = None,
        residual_target: float = 1e-12,
        iteration_limit: int = 500,
    ):
        self.name = name
        self.dimension = dimension
        self.min_level = min_level
        self.max_level = max_level
        self.field_names = list(fields)
        self.fields = [sympy.Symbol(f) for f in fields]
        self.equation_strings = list(equation_strings)
        self.operator_factories = dict(operator_factories)
        self.rhs_functions = rhs_functions
        self.dtype = dtype
        self.parameters = dict(parameters or {})
        self.uses_fas = uses_fas
        self.constants = dict(constants or {})
        self.outer_solver = outer_solver
        self.residual_target = residual_target
        self.iteration_limit = iteration_limit
        self.coarsening_factors = [(2,) * dimension for _ in self.fields]
        self._build()

    def _build(self):
        self.equations: List[mg.EquationInfo] = []
        self.operators: List[mg.OperatorInfo] = []
        subs = {sympy.Symbol(k): v for k, v in self.constants.items()}
        for level in range(self.min_level, self.max_level + 1):
            for eq_name, expr in self.equation_strings:
                info = mg.EquationInfo(eq_name, level, expr)
                if subs:
                    info.sympy_expr = info.sympy_expr.subs(subs)
                self.equations.append(info)
            for op_name, (factory, op_type) in self.operator_factories.items():
                self.operators.append(
                    mg.OperatorInfo(op_name, level, factory(level, self.parameters), op_type)
                )
        # Each equation belongs to its field in declaration order.
        for level in range(self.min_level, self.max_level + 1):
            eqs = [e for e in self.equations if e.level == level]
            for eq, field in zip(eqs, self.fields):
                eq.associated_field = field

    # ---- derived structures ----

    @property
    def finest_grid(self) -> List[base.Grid]:
        return [make_grid(self.max_level, self.dimension) for _ in self.fields]

    def grid_at(self, level: int) -> List[base.Grid]:
        return [make_grid(level, self.dimension) for _ in self.fields]

    def approximation(self) -> system.Approximation:
        return system.Approximation(
            "u",
            [base.Approximation(fn, g) for fn, g in zip(self.field_names, self.finest_grid)],
        )

    def rhs(self) -> system.RightHandSide:
        return system.RightHandSide(
            "f",
            [base.RightHandSide(f"{fn}_rhs", g) for fn, g in zip(self.field_names, self.finest_grid)],
        )

    def finest_operator(self) -> system.Operator:
        return mg.generate_system_operator(
            self.equations, self.operators, self.fields, self.max_level, 0, self.finest_grid
        )

    def interior_coordinates(self, level: int):
        n = 2**level
        axes = [np.arange(1, n) / n for _ in range(self.dimension)]
        return np.meshgrid(*axes, indexing="ij")

    def rhs_arrays(self, dtype, level: Optional[int] = None, device=None) -> Tuple:
        """Right-hand side per field: numpy with ``device=None``, else
        torch tensors on ``device``."""
        mesh = self.interior_coordinates(level if level is not None else self.max_level)
        np_dtype = numpy_dtype(dtype)
        out = []
        for i, _ in enumerate(self.fields):
            fn = None if self.rhs_functions is None else self.rhs_functions[i]
            if fn is None:
                out.append(np.zeros(mesh[0].shape, dtype=np_dtype))
            else:
                out.append(np.asarray(fn(*mesh), dtype=np_dtype))
        return _to_device(out, device)

    def initial_state(self, dtype, level: Optional[int] = None, device=None,
                      rhs_seed: Optional[int] = None,
                      init_seed: Optional[int] = None):
        """(u0, f): zero initial guess and the evaluated right-hand side,
        numpy with ``device=None``, else torch tensors on ``device``.

        Seeds as in the reference (evostencils_tpu/problems/api.py:139-193):
        ``rhs_seed`` forces a seeded random f, ``init_seed`` a seeded
        random u0, and a problem without RHS functions gets the fixed
        random f of seed 42."""
        grids = self.finest_grid if level is None else self.grid_at(level)
        shapes = [g.interior_shape for g in grids]
        np_dtype = numpy_dtype(dtype)
        if init_seed is not None:
            rng0 = np.random.default_rng(int(init_seed))
            u0 = tuple(rng0.standard_normal(s).astype(np_dtype) for s in shapes)
        else:
            u0 = tuple(np.zeros(s, dtype=np_dtype) for s in shapes)
        if rhs_seed is not None:
            rng = np.random.default_rng(rhs_seed)
            f = tuple(rng.standard_normal(s).astype(np_dtype) for s in shapes)
        elif self.rhs_functions is not None:
            f = self.rhs_arrays(dtype, level=level)
        else:
            rng = np.random.default_rng(42)
            f = tuple(rng.standard_normal(s).astype(np_dtype) for s in shapes)
        return _to_device(u0, device), _to_device(f, device)

    # ---- reconfiguration ----

    def _clone(self, **overrides) -> "Problem":
        kwargs = dict(
            name=self.name,
            dimension=self.dimension,
            min_level=self.min_level,
            max_level=self.max_level,
            fields=self.field_names,
            equation_strings=self.equation_strings,
            operator_factories=self.operator_factories,
            rhs_functions=self.rhs_functions,
            dtype=self.dtype,
            parameters=self.parameters,
            uses_fas=self.uses_fas,
            constants=self.constants,
            outer_solver=self.outer_solver,
            residual_target=self.residual_target,
            iteration_limit=self.iteration_limit,
        )
        kwargs.update(overrides)
        return type(self)(**kwargs)

    def with_levels(self, min_level: int, max_level: int) -> "Problem":
        return self._clone(min_level=min_level, max_level=max_level)

    def with_parameters(self, updates: Dict) -> "Problem":
        params = dict(self.parameters)
        params.update(updates)
        return self._clone(parameters=params)
