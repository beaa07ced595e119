"""Local Fourier Analysis: spectral-radius prediction of cycle IR (a copy of
evostencils_tpu/models/lfa.py that imports the port's IR and stencils;
numpy only, so both packages predict the same ρ).

Self-contained replacement for the external LFA Lab C++ library the
reference drives through SWIG (reference
model_based_prediction/convergence.py:1-208, gallery.py:188-219).

Theory (Wienands & Joppich): on an infinite grid every constant stencil
acts diagonally on Fourier modes e^{iθ·x}.  Coarsening by 2 aliases modes
in groups ("harmonics"); a hierarchy with n coarsenings couples C = 2^n
modes per axis.  We additionally reserve one halving for period-2
coefficient patterns (red-black masks), so C = 2^(n+1).  Every IR node
lowers to a batched matrix symbol over a sampled base-frequency grid:

  * stencil operator at level ℓ  → diagonal, entries ŝ(2^ℓ θ_k),
  * periodic stencil (period p)  → couples classes k → k + m·M/p with
    discrete-Fourier coefficients of the per-cell symbols,
  * restriction / prolongation   → injection ∘ stencil factorization
    (rectangular symbols between harmonic class spaces, matching the
    executable kernels in ops/intergrid.py by construction),
  * Inverse / CoarseGridSolver   → per-frequency matrix inverse,
  * Cycle                        → I + ω·E, with the red-black two-sweep
    composition (black + red·T)(red + black·T).

ρ = max over sampled frequencies of |eigenvalues|.  All assembly is
vectorized numpy over the frequency batch (the matrices are tiny — the
reference confines model-based estimation to ≤2-level hierarchies,
scripts/optimize.py:101-103); eigenvalues use numpy's batched eigvals.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from evostencils_torch.ir import base, system
from evostencils_torch.ir import partitioning as part
from evostencils_torch.stencils import constant, periodic


class FrequencySpace:
    """Sampled base frequencies + harmonic bookkeeping.

    C: harmonics per axis (power of two).  Base frequencies θ0 are
    sampled at cell midpoints of [-π/C, π/C)^d (never exactly 0, where
    the Poisson symbol is singular).  Class space at level ℓ has
    M = C / 2^ℓ representatives per axis.
    """

    def __init__(self, dimension: int, n_coarsenings: int, samples_per_axis: int = 8):
        self.dimension = dimension
        self.C = 2 ** (n_coarsenings + 1)
        axes = [
            (-np.pi / self.C) + (np.arange(samples_per_axis) + 0.5)
            * (2 * np.pi / self.C / samples_per_axis)
            for _ in range(dimension)
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.theta0 = np.stack([m.ravel() for m in mesh], axis=-1)  # (B, d)
        self.batch = self.theta0.shape[0]

    def classes(self, level: int) -> int:
        m = self.C >> level
        if m < 1:
            raise ValueError(f"Level {level} exceeds harmonic capacity C={self.C}")
        return m

    def class_tuples(self, level: int):
        m = self.classes(level)
        return list(np.ndindex(*([m] * self.dimension)))

    def frequencies(self, level: int) -> np.ndarray:
        """ω_k = 2^ℓ (θ0 + 2π k / C) for all class representatives k.

        Returns (B, H, d) with H = M^d, classes flattened C-order.
        """
        m = self.classes(level)
        ks = np.array(self.class_tuples(level))  # (H, d)
        theta = self.theta0[:, None, :] + 2 * np.pi * ks[None, :, :] / self.C
        return (2**level) * theta


def stencil_symbol(stencil: constant.Stencil, omega: np.ndarray) -> np.ndarray:
    """ŝ(ω) = Σ v_o e^{i o·ω}; omega (..., d) -> (...) complex."""
    out = np.zeros(omega.shape[:-1], dtype=np.complex128)
    for offset, value in stencil.entries:
        phase = omega @ np.asarray(offset, dtype=np.float64)
        out += complex(value) * np.exp(1j * phase)
    return out


class Symbol:
    """Batched frequency-space matrix between harmonic class spaces."""

    __slots__ = ("data", "level_out", "level_in", "space", "n_fields")

    def __init__(self, data, level_out, level_in, space, n_fields):
        self.data = data  # (B, nf*H_out, nf*H_in)
        self.level_out = level_out
        self.level_in = level_in
        self.space = space
        self.n_fields = n_fields

    def __matmul__(self, other: "Symbol") -> "Symbol":
        if self.level_in != other.level_out:
            raise ValueError("Symbol level mismatch in composition")
        return Symbol(
            self.data @ other.data, self.level_out, other.level_in, self.space, self.n_fields
        )

    def __add__(self, other: "Symbol") -> "Symbol":
        return Symbol(
            self.data + other.data, self.level_out, self.level_in, self.space, self.n_fields
        )

    def __sub__(self, other: "Symbol") -> "Symbol":
        return Symbol(
            self.data - other.data, self.level_out, self.level_in, self.space, self.n_fields
        )

    def __rmul__(self, factor) -> "Symbol":
        return Symbol(
            factor * self.data, self.level_out, self.level_in, self.space, self.n_fields
        )

    def inverse(self) -> "Symbol":
        return Symbol(
            np.linalg.inv(self.data), self.level_in, self.level_out, self.space, self.n_fields
        )

    def matching_identity(self) -> "Symbol":
        n = self.data.shape[-1]
        eye = np.broadcast_to(np.eye(n, dtype=np.complex128), self.data.shape).copy()
        return Symbol(eye, self.level_in, self.level_in, self.space, self.n_fields)

    def matching_zero(self) -> "Symbol":
        return Symbol(np.zeros_like(self.data), self.level_out, self.level_in, self.space, self.n_fields)

    def spectral_radius(self) -> float:
        eigs = np.linalg.eigvals(self.data)
        return float(np.max(np.abs(eigs)))


class ConvergenceEvaluator:
    """IR → LFA symbol transform + spectral radius.

    API parity with the reference ConvergenceEvaluator
    (model_based_prediction/convergence.py:29-208): construct per problem,
    call `compute_spectral_radius(expression)`; returns 0.0 on failure
    (fitness poisoning upstream).
    """

    def __init__(self, dimension, coarsening_factors, finest_grid,
                 samples_per_axis: Optional[int] = None):
        self.dimension = dimension
        self.coarsening_factors = coarsening_factors
        self.finest_grid = list(finest_grid)
        self.finest_level = self.finest_grid[0].level
        if samples_per_axis is None:
            samples_per_axis = 8 if dimension <= 2 else 4
        self.samples_per_axis = samples_per_axis

    def reinitialize_lfa_grids(self, finest_grid: List[base.Grid]):
        self.finest_grid = list(finest_grid)
        self.finest_level = self.finest_grid[0].level

    # -- helpers -----------------------------------------------------------

    def _level_distance(self, grid) -> int:
        g = grid[0] if isinstance(grid, list) else grid
        return self.finest_level - g.level

    def _expression_depth(self, expression) -> int:
        from evostencils_torch.ir.transformations import obtain_coarsest_level

        if isinstance(expression, base.Cycle):
            return obtain_coarsest_level(expression)
        return 1

    def _scalar_symbol(self, stencil, level: int, space: FrequencySpace) -> np.ndarray:
        """(B, H, H) symbol of a scalar constant/periodic stencil at level."""
        pstencil = periodic.lift(stencil)
        m = space.classes(level)
        H = m**space.dimension
        omega = space.frequencies(level)  # (B, H, d)
        out = np.zeros((space.batch, H, H), dtype=np.complex128)
        classes = space.class_tuples(level)
        index_of = {c: i for i, c in enumerate(classes)}
        p = pstencil.period
        if any(m % pi != 0 for pi in p):
            raise ValueError(f"Period {p} incompatible with class space {m}")
        cells = list(np.ndindex(*p))
        # per-cell symbols at every harmonic frequency: (B, H) each
        cell_symbols = {
            c: stencil_symbol(pstencil.cells[c], omega) if pstencil.cells[c] is not None
            and pstencil.cells[c].number_of_entries > 0
            else np.zeros((space.batch, H), dtype=np.complex128)
            for c in cells
        }
        inv_p = 1.0 / float(np.prod(p))
        for mvec in cells:
            # discrete Fourier coefficient of the periodic coefficient field
            coeff = np.zeros((space.batch, H), dtype=np.complex128)
            for c in cells:
                phase = -2 * np.pi * sum(mi * ci / pi for mi, ci, pi in zip(mvec, c, p))
                coeff += cell_symbols[c] * np.exp(1j * phase)
            coeff *= inv_p
            if not np.any(coeff):
                continue
            shift = tuple((mi * m) // pi for mi, pi in zip(mvec, p))
            for k_idx, k in enumerate(classes):
                k_new = tuple((ki + si) % m for ki, si in zip(k, shift))
                out[:, index_of[k_new], k_idx] += coeff[:, k_idx]
        return out

    def _block_symbol(self, entries_fn, n_fields, rows_cols) -> np.ndarray:
        """Assemble (B, nf*H_out, nf*H_in) from per-entry scalar symbols."""
        B = None
        blocks = []
        for i in range(rows_cols[0]):
            row = []
            for j in range(rows_cols[1]):
                s = entries_fn(i, j)
                row.append(s)
                B = s.shape[0]
            blocks.append(row)
        return np.concatenate(
            [np.concatenate(row, axis=-1) for row in blocks], axis=-2
        )

    # -- entry symbol for scalar operator expressions ----------------------

    def _entry_symbol(self, entry, level, space) -> np.ndarray:
        if isinstance(entry, base.ZeroOperator):
            H = space.classes(level) ** space.dimension
            return np.zeros((space.batch, H, H), dtype=np.complex128)
        stencil = entry.generate_stencil()
        if stencil is None:
            raise RuntimeError(f"No stencil for entry {entry!r}")
        return self._scalar_symbol(stencil, level, space)

    def _operator_symbol(self, operator: system.Operator, space) -> Symbol:
        level = self._level_distance(operator.grid)
        n = len(operator.entries)

        first = operator.entries[0][0]
        if isinstance(first, base.InterGridOperator):
            return self._intergrid_symbol(operator, space)

        data = self._block_symbol(
            lambda i, j: self._entry_symbol(operator.entries[i][j], level, space),
            n,
            (n, n),
        )
        return Symbol(data, level, level, space, n)

    def _intergrid_symbol(self, operator, space) -> Symbol:
        n = len(operator.entries)
        sample = operator.entries[0][0]
        fine_level = self._level_distance(sample.fine_grid)
        coarse_level = self._level_distance(sample.coarse_grid)
        m_f = space.classes(fine_level)
        m_c = space.classes(coarse_level)
        H_f = m_f**space.dimension
        H_c = m_c**space.dimension
        fine_classes = space.class_tuples(fine_level)
        coarse_index = {
            c: i for i, c in enumerate(space.class_tuples(coarse_level))
        }
        omega_f = space.frequencies(fine_level)
        inv2d = 1.0 / (2**space.dimension)

        def build(i, j):
            entry = operator.entries[i][j]
            if isinstance(entry, (base.ZeroRestriction, base.ZeroProlongation)):
                if isinstance(entry, base.ZeroRestriction):
                    return np.zeros((space.batch, H_c, H_f), dtype=np.complex128)
                return np.zeros((space.batch, H_f, H_c), dtype=np.complex128)
            stencil = entry.generate_stencil()
            if isinstance(stencil, periodic.PeriodicStencil):
                stencil = stencil.as_constant()
            svals = stencil_symbol(stencil, omega_f)  # (B, H_f)
            if isinstance(entry, base.Restriction):
                out = np.zeros((space.batch, H_c, H_f), dtype=np.complex128)
                for k_idx, k in enumerate(fine_classes):
                    kc = tuple(ki % m_c for ki in k)
                    out[:, coarse_index[kc], k_idx] += svals[:, k_idx]
                return out
            if isinstance(entry, base.Prolongation):
                out = np.zeros((space.batch, H_f, H_c), dtype=np.complex128)
                for k_idx, k in enumerate(fine_classes):
                    kc = tuple(ki % m_c for ki in k)
                    out[:, k_idx, coarse_index[kc]] += inv2d * svals[:, k_idx]
                return out
            raise RuntimeError(f"Unknown intergrid entry {entry!r}")

        data = self._block_symbol(build, n, (n, n))
        if isinstance(sample, base.Restriction):
            return Symbol(data, coarse_level, fine_level, space, n)
        return Symbol(data, fine_level, coarse_level, space, n)

    def _filter_symbols(self, operator: system.Operator, space, partitioning):
        """(red, black) block-diagonal filter symbols for a smoother's
        operator (off-diagonal blocks are zero, reference
        convergence.py:98-103)."""
        level = self._level_distance(operator.grid)
        n = len(operator.entries)
        m = space.classes(level)
        H = m**space.dimension

        filters = []
        for which in range(2):
            blocks = []
            for i in range(n):
                row = []
                for j in range(n):
                    if i == j:
                        entry = operator.entries[i][j]
                        stencils = partitioning.generate(
                            entry.generate_stencil(), entry.grid
                        )
                        row.append(
                            self._scalar_symbol(stencils[which], level, space)
                        )
                    else:
                        row.append(
                            np.zeros((space.batch, H, H), dtype=np.complex128)
                        )
                blocks.append(row)
            data = np.concatenate(
                [np.concatenate(r, axis=-1) for r in blocks], axis=-2
            )
            filters.append(Symbol(data, level, level, space, n))
        return filters

    # -- the main transform (structure mirrors reference convergence.py:62-174)

    def transform(self, expression: base.Expression, space: FrequencySpace) -> Symbol:
        # Cache key includes the frequency-space signature: operator
        # entities are shared across trees of different depths, and a
        # symbol from a different harmonic space must not be reused.
        key = ("lfa_symbol", space.C, space.batch, self.finest_level)
        cached = expression.analysis_cache.get(key)
        if cached is not None:
            return cached
        result = self._transform(expression, space)
        expression.analysis_cache[key] = result
        return result

    def _transform(self, expression, space) -> Symbol:
        if isinstance(expression, base.Cycle):
            correction = self.transform(expression.correction, space)
            if isinstance(expression.approximation, system.ZeroApproximation):
                approximation = correction.matching_zero()
            elif isinstance(expression.approximation, system.Approximation):
                approximation = correction.matching_identity()
            else:
                approximation = self.transform(expression.approximation, space)
            tmp = approximation + expression.relaxation_factor * correction
            if expression.partitioning is part.Single or isinstance(
                expression.partitioning, part.Single
            ):
                return tmp
            if expression.partitioning is part.RedBlack or isinstance(
                expression.partitioning, part.RedBlack
            ):
                # Exact affine error propagation of the two masked
                # half-sweeps with the residual recomputed between colors
                # (matches ops/smoothers.py + the LFA-validated executable):
                #   G(m) = I − ω·m·B̂⁻¹Â,  H(m) = ω·m·B̂⁻¹,
                #   result = G_b G_r Û + (G_b H_r + H_b) F̂.
                # The reference's textbook composition
                # (black + red·tmp)(red + black·tmp)
                # (convergence.py:106) is the special case Û = I, F̂ = 0 —
                # it mis-predicts chained smoothing steps, which is why we
                # compose exactly here (see tests vs Trottenberg TGM table).
                corr = expression.correction
                if not (
                    isinstance(corr, base.Multiplication)
                    and isinstance(corr.operand1, base.Inverse)
                    and isinstance(corr.operand2, base.Residual)
                ):
                    raise RuntimeError("Red-black requires a smoothing correction")
                residual = corr.operand2
                a_hat = self.transform(residual.operator, space)
                b_inv = self.transform(corr.operand1.operand, space).inverse()
                operator = corr.operand1.operand
                while not isinstance(operator, system.Operator):
                    if isinstance(operator, base.UnaryExpression):
                        operator = operator.operand
                    else:
                        raise RuntimeError("Cannot partition this smoother")
                red, black = self._filter_symbols(operator, space, part.RedBlack)
                omega = expression.relaxation_factor
                identity = a_hat.matching_identity()

                if isinstance(residual.rhs, system.RightHandSide):
                    f_hat = a_hat.matching_zero()
                else:
                    f_hat = self.transform(residual.rhs, space)

                g_r = identity - omega * (red @ (b_inv @ a_hat))
                g_b = identity - omega * (black @ (b_inv @ a_hat))
                h_r = omega * (red @ b_inv)
                h_b = omega * (black @ b_inv)
                return (g_b @ g_r) @ approximation + (g_b @ h_r + h_b) @ f_hat
            raise NotImplementedError("Unknown partitioning")

        if isinstance(expression, base.Residual):
            operator = self.transform(expression.operator, space)
            if isinstance(expression.rhs, system.RightHandSide):
                rhs = operator.matching_zero()
            else:
                rhs = self.transform(expression.rhs, space)
            if isinstance(expression.approximation, system.ZeroApproximation):
                approximation = rhs.matching_zero()
            elif isinstance(expression.approximation, system.Approximation):
                approximation = operator.matching_identity()
            else:
                approximation = self.transform(expression.approximation, space)
            return rhs - operator @ approximation

        if isinstance(expression, base.Multiplication):
            return self.transform(expression.operand1, space) @ self.transform(
                expression.operand2, space
            )
        if isinstance(expression, base.Addition):
            return self.transform(expression.operand1, space) + self.transform(
                expression.operand2, space
            )
        if isinstance(expression, base.Subtraction):
            return self.transform(expression.operand1, space) - self.transform(
                expression.operand2, space
            )
        if isinstance(expression, base.Scaling):
            return expression.factor * self.transform(expression.operand, space)
        if isinstance(expression, base.Inverse):
            return self.transform(expression.operand, space).inverse()
        if isinstance(expression, system.Diagonal):
            inner = expression.operand
            level = self._level_distance(inner.grid)
            n = len(inner.entries)
            H = space.classes(level) ** space.dimension

            def entry(i, j):
                if i != j:
                    return np.zeros((space.batch, H, H), dtype=np.complex128)
                return self._scalar_symbol(
                    periodic.diagonal(inner.entries[i][i].generate_stencil()),
                    level,
                    space,
                )

            return Symbol(self._block_symbol(entry, n, (n, n)), level, level, space, n)
        if isinstance(expression, system.ElementwiseDiagonal):
            inner = expression.operand
            level = self._level_distance(inner.grid)
            n = len(inner.entries)

            def entry(i, j):
                return self._scalar_symbol(
                    periodic.diagonal(inner.entries[i][j].generate_stencil()),
                    level,
                    space,
                )

            return Symbol(self._block_symbol(entry, n, (n, n)), level, level, space, n)
        if isinstance(expression, base.CoarseGridSolver):
            return self.transform(expression.operator, space).inverse()
        if isinstance(expression, system.Operator):
            return self._operator_symbol(expression, space)
        raise NotImplementedError(f"LFA transform: {type(expression).__name__}")

    # -- public API --------------------------------------------------------

    def compute_spectral_radius(self, expression: base.Expression) -> float:
        try:
            depth = self._expression_depth(expression)
            space = FrequencySpace(
                self.dimension, depth, self.samples_per_axis
            )
            symbol = self.transform(expression, space)
            rho = symbol.spectral_radius()
            if not math.isfinite(rho):
                return 0.0
            return rho
        except (
            ArithmeticError,
            RuntimeError,
            MemoryError,
            ValueError,
            NotImplementedError,
            np.linalg.LinAlgError,
        ):
            return 0.0

    def compute_eigenvalues(self, expression: base.Expression):
        depth = self._expression_depth(expression)
        space = FrequencySpace(self.dimension, depth, self.samples_per_axis)
        symbol = self.transform(expression, space)
        return np.linalg.eigvals(symbol.data)
