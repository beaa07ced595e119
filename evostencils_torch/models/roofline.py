"""Roofline performance model with NVIDIA H100 constants (the port of
evostencils_tpu/models/roofline.py; the walker is the reference's, line for
line).

Same estimation structure as the reference PerformanceEvaluator
(model_based_prediction/performance.py:6-271): walk the cycle IR counting
operations and transferred words per grid cell, convert to runtime via
min(peak_compute, AI · bandwidth), add per-node runtimes bottom-up with
memoization; red-black sweeps get an empirical penalty factor; the
coarse-grid-solver cost is injected (here: the cost of one dense matvec
of the assembled inverse).

What it predicts: the DEVICE time of one cycle on one H100, the quantity
`utils/timing.per_cycle_time` measures on the card by replaying the cycle
captured in a CUDA graph.  It is not a wall-clock model: an eager cycle's
host dispatch (~540 launches) keeps the card idle most of the time, and the
wall time of a cycle is several times its device time (PERF.md records
the ratio beside the fit).

Peak and bandwidth are NVIDIA's data-sheet figures for the H100 SXM, the
same that evostencils_torch/measure.py uses: 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM, 4 bytes a float32 word.

Calibration: the five factors below are fitted to per-cycle device times
of lowered reference cycles on the card (scripts/torch_calibrate_roofline.py
writes evostencils_torch/models/roofline_calibration_h100.json, and
tests/test_torch_models.py holds these constants to that file).  Eager
torch fuses nothing and applies a stencil as one shifted multiply-add per
coefficient, so the fusion factor is not the TPU's 3.5; every torch op is a
kernel launch with a device-side cost of microseconds, which
`kernel_launch_overhead` carries per costed pass.  That is one cost per
pass, not per launch: a plain-Jacobi sweep is ~13 launches, so the
launch-bound 511² Jacobi V-cycle is predicted at 0.70 of its device time,
outside the reference's 1.35 gate that every other case meets.

Besides runtime the walker also accumulates the modeled HBM traffic in
bytes (`estimate_traffic`), which scripts/torch_headline_1024.py divides by
the measured per-cycle device time to report achieved-bandwidth share.
"""

from __future__ import annotations

from functools import reduce

from evostencils_torch.ir import base, partitioning, system
from evostencils_torch.stencils import periodic

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
H100_PEAK_F32_FLOPS = 67e12
H100_HBM_BANDWIDTH = 3.35e12
# Fitted on NVIDIA H100 80GB HBM3, 700.00 W
# (scripts/torch_calibrate_roofline.py, roofline_calibration_h100.json).
RED_BLACK_PENALTY_H100 = 0.5612310241546865
KERNEL_LAUNCH_OVERHEAD_H100 = 3.5481338923357606e-06
FUSION_FACTOR_H100 = 1.2835688421125162
SINGLE_SWEEP_FUSION_H100 = 0.10705032786013145
INTERGRID_FACTOR_H100 = 9.51365692002177


class PerformanceEvaluator:
    def __init__(
        self,
        peak_performance: float = H100_PEAK_F32_FLOPS,
        peak_bandwidth: float = H100_HBM_BANDWIDTH,
        bytes_per_word: int = 4,
        runtime_coarse_grid_solver: float = 0.0,
        red_black_penalty: float = RED_BLACK_PENALTY_H100,
        kernel_launch_overhead: float = KERNEL_LAUNCH_OVERHEAD_H100,
        red_black_traffic_factor: float = 3.25 / 3.0,
        fusion_factor: float = None,
        single_sweep_fusion: float = None,
        intergrid_factor: float = None,
    ):
        self.peak_performance = peak_performance
        self.peak_bandwidth = peak_bandwidth
        self.bytes_per_word = bytes_per_word
        self.runtime_coarse_grid_solver = runtime_coarse_grid_solver
        self.red_black_penalty = red_black_penalty
        # Fixed device cost per costed pass: on the H100 each pass is one or
        # more kernel launches, which dominate on the small coarse grids.
        self.kernel_launch_overhead = kernel_launch_overhead
        # Traffic (not time) multiplier for red-black: the fused sweep's
        # halo re-reads (csrc/rb_sweep.cu) add ~8% over the 3-pass
        # single-sweep minimum.
        self.red_black_traffic_factor = red_black_traffic_factor
        # Effective words = counted words / fusion_factor (see
        # FUSION_FACTOR_H100).
        self.fusion_factor = (
            fusion_factor if fusion_factor is not None else FUSION_FACTOR_H100
        )
        # Extra word-fusion of single-partitioned smoothing sweeps (see
        # SINGLE_SWEEP_FUSION_H100).
        self.single_sweep_fusion = (
            single_sweep_fusion
            if single_sweep_fusion is not None
            else SINGLE_SWEEP_FUSION_H100
        )
        # Runtime multiplier of intergrid-transfer passes (the separable
        # transfers' extra passes; see INTERGRID_FACTOR_H100).
        self.intergrid_factor = (
            intergrid_factor
            if intergrid_factor is not None
            else INTERGRID_FACTOR_H100
        )

    def set_runtime_of_coarse_grid_solver(self, runtime: float):
        self.runtime_coarse_grid_solver = runtime

    # -- roofline core -----------------------------------------------------

    def compute_performance(self, intensity: float) -> float:
        return min(self.peak_performance, intensity * self.peak_bandwidth)

    def compute_arithmetic_intensity(self, operations: float, words: float) -> float:
        return operations / (words * self.bytes_per_word)

    def compute_runtime(self, operations: float, words: float, total_operations: float) -> float:
        if operations <= 0.0:
            return 0.0
        words = words / self.fusion_factor
        intensity = self.compute_arithmetic_intensity(operations, words)
        if intensity <= 0.0:
            return 0.0
        return (
            total_operations / self.compute_performance(intensity)
            + self.kernel_launch_overhead
        )

    def compute_bytes(self, operations: float, words: float, total_operations: float) -> float:
        """Modeled HBM traffic of a stencil pass: words/cell × cells.

        `total_operations = operations · cells` at every call site, so the
        cell count is recovered as their ratio."""
        if operations <= 0.0 or words <= 0.0:
            return 0.0
        cells = total_operations / operations
        return (words / self.fusion_factor) * cells * self.bytes_per_word

    # -- per-node op/word counting ----------------------------------------

    @staticmethod
    def _cells(grid_list) -> int:
        grids = grid_list if isinstance(grid_list, list) else [grid_list]
        return min(reduce(lambda a, b: a * b, g.size) for g in grids)

    @staticmethod
    def _stencil_entry_count(entry) -> int:
        stencil = entry.generate_stencil()
        if stencil is None:
            return 0
        cells = periodic.get_list_of_entries(stencil)
        if not cells:
            return 0
        return max(c.number_of_entries for c in cells)

    def _matvec_cost(self, operator, grid):
        """ops/words of one A·x application (no right-hand-side stream)."""
        n_fields = len(grid) if isinstance(grid, list) else 1
        operations = 0
        loads = 0
        offset_union = [set() for _ in range(n_fields)]
        for row in operator.entries:
            for i, entry in enumerate(row):
                stencil = entry.generate_stencil()
                if stencil is None:
                    continue
                cells = periodic.get_list_of_entries(stencil)
                if not cells:
                    continue
                n_entries = max(c.number_of_entries for c in cells)
                operations += 2 * n_entries  # mul + add per coefficient
                for c in cells:
                    for offset, _ in c.entries:
                        offset_union[i].add(offset)
        for s in offset_union:
            loads += len(s)
        return operations, loads + n_fields  # + store

    def _residual_cost(self, residual: base.Residual):
        operations, words = self._matvec_cost(residual.operator, residual.grid)
        grid = residual.grid
        n_fields = len(grid) if isinstance(grid, list) else 1
        return operations, words + n_fields  # + rhs stream

    def _smoother_cost(self, inverse_operand, residual: base.Residual):
        operations_r, words_r = self._residual_cost(residual)
        grid = residual.grid
        n_fields = len(grid) if isinstance(grid, list) else 1
        expression = inverse_operand
        if isinstance(expression, system.Diagonal):
            operations = n_fields + operations_r
            words = n_fields + words_r
        elif isinstance(expression, (system.ElementwiseDiagonal, system.Operator)):
            n = n_fields
            if isinstance(expression, system.Operator):
                for i in range(n_fields):
                    entry = expression.entries[i][i]
                    stencil = entry.generate_stencil()
                    n += len(periodic.count_number_of_entries(stencil)) - 1
            # Gaussian-elimination cost of the n×n local system
            multiplications = round(n**3 / 3 + n**2 - n / 3)
            additions = round(n**3 / 3 + n**2 / 2 - 5 * n / 6)
            operations = multiplications + additions + (n // n_fields) * operations_r
            words = n + (n // n_fields) * words_r
        elif isinstance(expression, base.Addition):
            # FAS Newton: D + J — treat as a collective point solve plus
            # one Jacobian evaluation per Newton step.
            steps = getattr(expression.operand2, "n_newton_steps", 1)
            operations = steps * (3 * n_fields + operations_r)
            words = n_fields + words_r
        else:
            raise NotImplementedError("Smoother not supported by roofline model")
        return operations, words

    def _intergrid_cost(self, operator):
        operations = 0
        words = 0
        for row in operator.entries:
            for entry in row:
                if isinstance(entry, (base.ZeroProlongation, base.ZeroRestriction)):
                    continue
                n = self._stencil_entry_count(entry)
                operations += 2 * n
                words += n + 1
        return operations, words

    # -- recursive runtime + traffic estimation ----------------------------
    # (reference performance.py:50-148, extended to carry modeled bytes)

    def estimate_runtime(self, expression: base.Expression) -> float:
        return self.estimate_runtime_and_traffic(expression)[0]

    def estimate_traffic(self, expression: base.Expression) -> float:
        """Modeled HBM bytes moved by one application of the cycle."""
        return self.estimate_runtime_and_traffic(expression)[1]

    def estimate_runtime_and_traffic(self, expression: base.Expression):
        cached = expression.analysis_cache.get("roofline_runtime")
        if cached is not None:
            return cached
        result = self._estimate(expression, {})
        expression.analysis_cache["roofline_runtime"] = result
        return result

    def _walk(self, expression, visited):
        """Each unique IR node contributes its cost ONCE per cycle
        application: the lowering computes shared subexpressions once
        (multiref handling in backend/lowering.py), so repeat references
        — e.g. the smoothed iterate appearing both as the cycle's
        approximation and inside its residual — add zero marginal cost.
        (The reference's memoized-add estimator double-counts these,
        inflating deep V-cycles ~2× per level.)"""
        key = id(expression)
        if key in visited:
            return 0.0, 0.0
        visited[key] = True
        return self._estimate(expression, visited)

    def _estimate(self, expression, visited):
        if isinstance(expression, base.Cycle):
            correction = expression.correction
            is_smoothing = False
            is_block_solve = False
            ig_pair = None
            if isinstance(correction, base.Residual):
                operations, words = 0, 0
                runtime, traffic = self._walk(correction, visited)
            elif isinstance(correction, base.Multiplication):
                if isinstance(correction.operand1, system.InterGridOperator):
                    runtime, traffic = self._walk(correction.operand2, visited)
                    operations, words = self._intergrid_cost(correction.operand1)
                    ig_pair = (operations, words)
                elif isinstance(correction.operand1, base.Inverse):
                    is_smoothing = True
                    # Block-local solves (system.Operator inverse) execute
                    # as masked coefficient-plane shifts — extra full-grid
                    # arrays that do NOT fuse like an unmasked point-Jacobi
                    # pass, so they keep the undiscounted word count.
                    is_block_solve = isinstance(
                        correction.operand1.operand, system.Operator
                    )
                    residual = correction.operand2
                    visited[id(residual)] = True
                    runtime, traffic = self._dependency_cost(residual, visited)
                    operations, words = self._smoother_cost(
                        correction.operand1.operand, residual
                    )
                else:
                    runtime, traffic = self._walk(correction, visited)
                    operations, words = 0, 0
            else:
                runtime, traffic = self._walk(correction, visited)
                operations, words = 0, 0
            grid = expression.grid
            n_fields = len(grid) if isinstance(grid, list) else 1
            operations += 2 * n_fields  # scale + add of the update
            words += 2 * n_fields  # load + store of the iterate
            is_red_black = expression.partitioning is partitioning.RedBlack or (
                isinstance(expression.partitioning, partitioning.RedBlack)
            )
            if is_smoothing and not is_red_black and not is_block_solve:
                # Plain-Jacobi sweeps fuse residual+scale+update into one
                # unmasked full-grid pass: fewer HBM words than red-black
                # (see SINGLE_SWEEP_FUSION_H100).  Fitted on point-Jacobi
                # cases only, so block-local solves are excluded.
                words = words / self.single_sweep_fusion
            cells = self._cells(expression.grid)
            step = self.compute_runtime(operations, words, operations * cells)
            step_bytes = self.compute_bytes(operations, words, operations * cells)
            if ig_pair is not None and self.intergrid_factor != 1.0:
                # Surcharge only the transfer part of the pass (see
                # INTERGRID_FACTOR_H100).
                ig_ops, ig_words = ig_pair
                step += (self.intergrid_factor - 1.0) * self.compute_runtime(
                    ig_ops, ig_words, ig_ops * cells
                )
            if is_red_black:
                step *= self.red_black_penalty
                step_bytes *= self.red_black_traffic_factor
            return runtime + step, traffic + step_bytes

        if isinstance(expression, base.Residual):
            runtime, traffic = self._dependency_cost(expression, visited)
            operations, words = self._residual_cost(expression)
            cells = self._cells(expression.grid)
            return (
                runtime + self.compute_runtime(operations, words, operations * cells),
                traffic + self.compute_bytes(operations, words, operations * cells),
            )

        if isinstance(expression, base.Multiplication):
            op1 = expression.operand1
            if isinstance(op1, system.InterGridOperator):
                runtime, traffic = self._walk(expression.operand2, visited)
                operations, words = self._intergrid_cost(op1)
                cells = self._cells(expression.grid)
                return (
                    runtime
                    + self.intergrid_factor
                    * self.compute_runtime(operations, words, operations * cells),
                    traffic
                    + self.compute_bytes(operations, words, operations * cells),
                )
            if isinstance(op1, base.CoarseGridSolver):
                runtime, traffic = self._walk(expression.operand2, visited)
                if op1.expression is not None and hasattr(op1.expression, "expression"):
                    r2, t2 = self._walk(op1.expression.expression, visited)
                    runtime += r2
                    traffic += t2
                elif self.runtime_coarse_grid_solver:
                    runtime += self.runtime_coarse_grid_solver
                else:
                    # Dense inverse matvec (ops/coarse_solve.py): 2·N² flops,
                    # N = coarse unknowns; the N² matrix is streamed from HBM
                    # each application.
                    n = self._cells(op1.grid) * (
                        len(op1.grid) if isinstance(op1.grid, list) else 1
                    )
                    runtime += max(
                        2.0 * n * n / self.peak_performance,
                        n * n * self.bytes_per_word / self.peak_bandwidth,
                    ) + self.kernel_launch_overhead
                    traffic += n * n * self.bytes_per_word
                return runtime, traffic
            if isinstance(op1, base.Inverse):
                residual = expression.operand2
                visited[id(residual)] = True
                runtime, traffic = self._dependency_cost(residual, visited)
                operations, words = self._smoother_cost(op1.operand, residual)
                cells = self._cells(expression.grid)
                return (
                    runtime
                    + self.compute_runtime(operations, words, operations * cells),
                    traffic
                    + self.compute_bytes(operations, words, operations * cells),
                )
            if isinstance(op1, system.Operator):
                # FAS τ-correction A_c·(R·u): a full operator matvec —
                # previously dropped, leaving FAS cycles under-costed.
                runtime, traffic = self._walk(expression.operand2, visited)
                operations, words = self._matvec_cost(op1, expression.grid)
                cells = self._cells(expression.grid)
                return (
                    runtime
                    + self.compute_runtime(operations, words, operations * cells),
                    traffic
                    + self.compute_bytes(operations, words, operations * cells),
                )
            # Shared `visited` so subexpressions already costed by the
            # caller are not double-counted.
            return self._walk(expression.operand2, visited)

        if isinstance(expression, (base.Addition, base.Subtraction)):
            grid = expression.grid
            n_fields = len(grid) if isinstance(grid, list) else 1
            cells = self._cells(grid)
            ops = n_fields
            words = 3 * n_fields
            r1, t1 = self._walk(expression.operand1, visited)
            r2, t2 = self._walk(expression.operand2, visited)
            return (
                r1 + r2 + self.compute_runtime(ops, words, ops * cells),
                t1 + t2 + self.compute_bytes(ops, words, ops * cells),
            )
        if isinstance(expression, base.Scaling):
            return self._walk(expression.operand, visited)
        if isinstance(expression, (base.Entity, system.System)):
            return 0.0, 0.0
        raise NotImplementedError(f"Roofline: {type(expression).__name__}")

    def _dependency_cost(self, residual: base.Residual, visited):
        runtime, traffic = 0.0, 0.0
        if not isinstance(residual.rhs, system.RightHandSide):
            r, t = self._walk(residual.rhs, visited)
            runtime += r
            traffic += t
        if not isinstance(residual.approximation, system.Approximation) or isinstance(
            residual.approximation, base.Cycle
        ):
            if not type(residual.approximation) in (
                system.Approximation,
                system.ZeroApproximation,
            ):
                r, t = self._walk(residual.approximation, visited)
                runtime += r
                traffic += t
        return runtime, traffic
