"""Fitness evaluation of evolved cycles in torch (counterpart of
evostencils_tpu/backend/evaluation.py, real dtypes, no outer Krylov solve).

`TorchProgramGenerator` implements the optimizer-facing protocol of the
reference's `JaxProgramGenerator` and measures the same fitness: ρ, time
to the 1e-12 residual target and the iteration count, with infinity for
failures.
  * float32: ρ from a power iteration on the error-propagation operator
    (blocks of 10 cycles, renormalised every cycle, 3 to 8 blocks, a 2 %
    stopping rule); iterations = ⌈log ε / log ρ⌉; time per cycle from the
    residual-driven stage solve.
  * float64: residual-driven stages, restarted from the exact host-f64
    residual when a stage stalls at its floor.

`generate_and_evaluate_group` scores same-structure individuals (the
optimizer's ω-mutation offspring) as the reference's group path does: ρ
per member, one time per iteration measured on the first survivor and
shared.

The generator runs on the card unless the caller asks for the CPU
(`device="cpu"`).  The reference's device loops (`lax.while_loop`) are
host loops here: the stage reads each cycle's residual norm back to decide
whether to go on, and decides in the tensor's dtype as the reference does
on the device, so the executed count and the exit reason match.  Times
are CUDA-event spans on a GPU and `perf_counter` spans on the CPU.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from evostencils_torch import NotPortedError, numpy_dtype
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import Program
from evostencils_torch.ir import base
from evostencils_torch.ir.transformations import canonical_string, collect_cycles
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.stencils import periodic

# A power-iteration rate of exactly 0.0 is an f32 underflow of a superb
# cycle's error norm — clamp to a finite, best-ordered value.
ZERO_RATE_CLAMP = 1e-16

# The reference's largest vmapped group; larger groups are split.
GROUP_SIZE_LIMIT = 16

# Device faults that poison one individual (a run of them aborts); checked
# before the RuntimeError family they belong to.
_DEVICE_ERRORS = (torch.cuda.OutOfMemoryError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()
)


class TorchProgramGenerator:
    """Evaluate evolved cycles with torch on `device` (the card by default).

    Implements the optimizer-facing protocol: `generate_storage`,
    `initialize_code_generation`, `generate_cycle_function`,
    `generate_and_evaluate`, `generate_and_evaluate_group`,
    `evaluate_objectives`, `reinitialize`, `uses_FAS`, plus the problem
    properties.
    """

    def __init__(
        self,
        problem,
        dtype=None,
        epsilon: Optional[float] = None,
        iteration_limit: Optional[int] = None,
        measure_reduction: Optional[float] = None,
        device="cuda",
    ):
        self.problem = problem
        self.device = torch.device(device)
        self.dtype = dtype if dtype is not None else problem.dtype
        self._np_dtype = numpy_dtype(self.dtype)
        self.epsilon = epsilon if epsilon is not None else problem.residual_target
        self.iteration_limit = (
            iteration_limit if iteration_limit is not None else problem.iteration_limit
        )
        if measure_reduction is None:
            # float64 measures the full target in one stage; float32 in
            # stage windows of 1e-4, well above its residual floor.
            is_f64 = self._np_dtype == np.float64
            measure_reduction = self.epsilon if is_f64 else max(self.epsilon, 1e-4)
        self.measure_reduction = measure_reduction
        self.lowering = CycleLowering(self.dtype, self.device)
        self._solver_cache = {}
        self._vms = {}
        self.run_time_total = 0.0
        # Seeded right-hand side / initial guess for sample-spread
        # re-measurement (Problem.initial_state).
        self.rhs_seed = None
        self.init_seed = None
        self._consecutive_device_failures = 0
        # How many solver builds took the cycle-VM path vs IR lowering.
        self.vm_hits = 0
        self.vm_misses = 0
        # Groups scored by generate_and_evaluate_group, and their members
        # (members of a group that fell back one by one are not counted).
        self.groups = 0
        self.group_members = 0

    def vm_stats(self) -> dict:
        total = self.vm_hits + self.vm_misses
        return {
            "vm_hits": self.vm_hits,
            "vm_misses": self.vm_misses,
            "vm_hit_rate": (self.vm_hits / total) if total else None,
        }

    def _apply_parameter_values(self, values) -> None:
        if any(self.problem.parameters.get(k) != v for k, v in values.items()):
            self.problem = self.problem.with_parameters(values)
            self._solver_cache.clear()
            self._vms.clear()

    def _device_failed(self):
        """Account one device fault: a lone faulting individual is poisoned,
        a run of five means the device is unusable and aborts the run."""
        self._consecutive_device_failures += 1
        if self._consecutive_device_failures >= 5:
            raise RuntimeError(
                f"{self._consecutive_device_failures} consecutive device "
                "failures — the device appears unusable"
            ) from None

    # ---- problem properties (protocol surface) ----

    @property
    def dimension(self):
        return self.problem.dimension

    @property
    def finest_grid(self):
        return self.problem.finest_grid

    @property
    def coarsening_factor(self):
        return self.problem.coarsening_factors

    @property
    def min_level(self):
        return self.problem.min_level

    @property
    def max_level(self):
        return self.problem.max_level

    @property
    def equations(self):
        return self.problem.equations

    @property
    def operators(self):
        return self.problem.operators

    @property
    def fields(self):
        return self.problem.fields

    def uses_FAS(self):
        return getattr(self.problem, "uses_fas", False)

    # ---- protocol no-ops (no external workspaces / files needed) ----

    def generate_storage(self, min_level, max_level, finest_grid):
        return []

    def initialize_code_generation(self, min_level, max_level, iteration_limit=None):
        if iteration_limit is not None:
            self.iteration_limit = iteration_limit

    def reinitialize(self, min_level, max_level, level_offset=0):
        """Generalization ramp: shift the level range."""
        self.problem = self.problem.with_levels(min_level, max_level)
        self._solver_cache.clear()
        self._vms.clear()

    def generate_cycle_function(self, expression, storages=None, min_level=None,
                                max_level=None, use_global_weights=False):
        """The durable program representation: the canonical IR string."""
        return canonical_string(expression)

    # ---- solver construction ----

    def _expression_level(self, expression) -> int:
        grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
        return grids[0].level

    def _finest_operator_for(self, expression):
        from evostencils_torch.grammar import multigrid as mg

        grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
        return mg.generate_system_operator(
            self.problem.equations, self.problem.operators, self.problem.fields,
            self._expression_level(expression), 0, grids,
        )

    def _vm_program(self, expression):
        """(vm, Program) when the expression is expressible in the VM ISA;
        (vm, None) on a translation miss; (None, None) for a single level."""
        level = self._expression_level(expression)
        if level - self.problem.min_level + 1 < 2:
            return None, None
        vm = self._vms.get(level)
        if vm is None:
            from evostencils_torch.backend.vm import CycleVM

            vm = CycleVM(self.lowering, self.problem, level)
            self._vms[level] = vm
        return vm, vm.translate(expression)

    def _build_solver(self, expression):
        """((stage, power, operator), omega_arg): the measurement functions
        around the cycle VM's step when the expression translates, else
        around the IR-lowered step.  `omega_arg` is the VM Program or the
        relaxation factors as float32 (the reference's traced ω vector)."""
        vm, program = self._vm_program(expression)
        if program is not None:
            self.vm_hits += 1
            key = ("__vm__", self._expression_level(expression))
            if key not in self._solver_cache:
                operator = self._finest_operator_for(expression)
                self._solver_cache[key] = self._stage_power_fns(vm.make_step(), operator) + (
                    operator,
                )
            return self._solver_cache[key], program
        self.vm_misses += 1
        omega_values = self._omega_vector(expression)
        key = ("solve", canonical_string(expression, parameterize_relaxation=True))
        if key not in self._solver_cache:
            step = self.lowering.lower_parameterized(expression)[0]
            operator = self._finest_operator_for(expression)
            self._solver_cache[key] = self._stage_power_fns(step, operator) + (operator,)
        return self._solver_cache[key], omega_values

    @staticmethod
    def _omega_vector(expression) -> np.ndarray:
        """The relaxation factors in canonical slot order, as float32."""
        return np.asarray(
            [float(c.relaxation_factor) for c in collect_cycles(expression)], dtype=np.float32
        )

    def _stage_power_fns(self, step, operator):
        """The two measurement loops around step(u, f, omega_arg): the
        residual-driven stage solve and the error-propagation power
        iteration."""
        lowering = self.lowering
        cap = self.iteration_limit
        np_dt = self._np_dtype.type
        target = np_dt(self.measure_reduction)
        # Pace rule: surviving poisoning needs ρ ≤ ε^(1/cap); 10× behind
        # that pace after 25 cycles, a stage stops.
        rho_required = np_dt(self.epsilon ** (1.0 / cap))
        grace = np_dt(10.0)
        divergence = np_dt(1e8)
        # Stall patience: at the f32 residual floor the best point so far
        # defines the stage's reduction.
        patience = 5

        def residual_norm(u, f):
            return sops.l2_norm(sops.tree_sub(f, lowering.system_apply(operator, u)))

        def stage(u0, rhs, omegas):
            """(best_res, res0, best_it, best_u, executed); the exit test is
            the reference's device test, evaluated in the tensor's dtype."""
            res0 = np_dt(residual_norm(u0, rhs).item())
            u, res, it, best_res, best_it, best_u = u0, res0, 0, res0, 0, u0
            while (
                it < cap
                and res > target * res0
                and res < divergence * res0
                and np.isfinite(res)
                and (it < 25 or res < grace * res0 * rho_required ** np_dt(it))
                and it - best_it < patience
            ):
                u = step(u, rhs, omegas)
                res = np_dt(residual_norm(u, rhs).item())
                it += 1
                if res < best_res:
                    best_it, best_u, best_res = it, u, res
            return best_res, res0, best_it, best_u, it

        block_len = 10

        def one_block(e, zf, omegas):
            # Renormalise every cycle and accumulate log-norms: a block
            # rate of ρ^10 underflows f32 for very fast cycles.
            log_acc = torch.zeros((), dtype=lowering.dtype, device=lowering.device)
            tiny = torch.finfo(lowering.dtype).tiny
            for _ in range(block_len):
                e = step(e, zf, omegas)
                n = sops.l2_norm(e)
                safe = torch.where(n > 0, n, 1.0)
                e = tuple(x / safe for x in e)
                log_acc = log_acc + torch.log(torch.where(n > 0, n, tiny))
            return e, np_dt(torch.exp(log_acc / block_len).item())

        def power(e0, zf, omegas):
            """(rate, cycles): blocks until the per-cycle rate settles."""
            e, rate = one_block(e0, zf, omegas)
            prev_rate, k = np_dt(0.0), 1
            while (
                k < 8
                and (k < 3 or abs(rate - prev_rate) > np_dt(0.02) * abs(rate))
                and rate < 2.0
                and np.isfinite(rate)
            ):
                e, new_rate = one_block(e, zf, omegas)
                prev_rate, rate, k = rate, new_rate, k + 1
            return rate, k * block_len

        return stage, power

    def _probe_error_seed(self):
        """Seed of the power iteration's random error: 7, shifted by the
        sample-spread seeds when they are set."""
        seed = 7
        if self.rhs_seed is not None:
            seed += int(self.rhs_seed)
        if self.init_seed is not None:
            seed += 1009 * int(self.init_seed)
        return seed

    def _timed_stage(self, stage, u0, f, omegas) -> float:
        """Seconds one stage solve takes on the device."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            stage(u0, f, omegas)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        stage(u0, f, omegas)
        return time.perf_counter() - t0

    def _to_device(self, host_state):
        return tuple(
            torch.from_numpy(np.ascontiguousarray(x, dtype=self._np_dtype)).to(self.device)
            for x in host_state
        )

    def _probe_state(self, expression):
        """(u0, f, e0, zf) on the device at the expression's level: the
        problem's initial state, the power iteration's seeded random error
        and its zero right-hand side."""
        u0_host, f_host = self.problem.initial_state(
            self.dtype, level=self._expression_level(expression),
            rhs_seed=self.rhs_seed, init_seed=self.init_seed,
        )
        rng = np.random.default_rng(self._probe_error_seed())
        e0 = self._to_device(
            rng.standard_normal(x.shape).astype(self._np_dtype) for x in u0_host
        )
        zf = self._to_device(np.zeros(x.shape, self._np_dtype) for x in u0_host)
        return self._to_device(u0_host), self._to_device(f_host), e0, zf

    def _power_verdict(self, rate, infinity):
        """(ρ, iterations, result) from a power-iteration rate.  `result`
        is the final fitness triple when the rate alone decides it (no
        valid ρ, ρ ≥ 1, or more iterations than the cap), else None."""
        if rate == 0.0:
            rate = ZERO_RATE_CLAMP
        if not math.isfinite(rate) or rate < 0.0:
            return infinity, infinity, (infinity, infinity, infinity)
        if rate >= 1.0:
            # A real solve would stop at the iteration cap.
            return rate, self.iteration_limit, (infinity, rate, self.iteration_limit)
        iterations = int(math.ceil(math.log(self.epsilon) / math.log(rate)))
        if iterations > self.iteration_limit:
            return rate, iterations, (infinity, rate, iterations)
        return rate, iterations, None

    def _time_per_iteration_ms(self, stage_solve, u0, f, omegas, evaluation_samples) -> float:
        """Median time of the stage solve over `evaluation_samples` runs,
        per cycle its first run executed."""
        executed = max(1, stage_solve(u0, f, omegas)[4])
        times = sorted(
            self._timed_stage(stage_solve, u0, f, omegas)
            for _ in range(max(1, evaluation_samples))
        )
        self.run_time_total += sum(times)
        return 1e3 * times[len(times) // 2] / executed

    # ---- core evaluation ----

    def generate_and_evaluate(
        self,
        expression,
        storages=None,
        min_level=None,
        max_level=None,
        solver_program=None,
        infinity=1e100,
        evaluation_samples=3,
        global_variable_values=None,
    ):
        """Returns (time_to_convergence_ms, convergence_factor, iterations)."""
        if getattr(self.problem, "outer_solver", None):
            raise NotPortedError("outer-Krylov (Helmholtz) evaluation")
        if self.uses_FAS():
            raise NotPortedError("FAS evaluation")
        if global_variable_values:
            self._apply_parameter_values(global_variable_values)
        try:
            return self._generate_and_evaluate_measured(expression, infinity, evaluation_samples)
        except _DEVICE_ERRORS:
            self._device_failed()
            return infinity, infinity, infinity

    def _generate_and_evaluate_measured(self, expression, infinity, evaluation_samples):
        try:
            (stage_solve, power_solve, operator), omegas = self._build_solver(expression)
            u0, f, e0, zf = self._probe_state(expression)

            if self._np_dtype == np.float32:
                # ρ by power iteration on the error-propagation operator.
                rate, _ = power_solve(e0, zf, omegas)
                self._consecutive_device_failures = 0
                rho, iterations, result = self._power_verdict(float(rate), infinity)
                if result is not None:
                    return result
                t_iter_ms = self._time_per_iteration_ms(
                    stage_solve, u0, f, omegas, evaluation_samples)
                return iterations * t_iter_ms, rho, iterations

            # Restarted measurement: when a stage stalls at its residual
            # floor before the target, the exact float64 host residual is
            # the next stage's right-hand side (the error equation), so
            # stage reductions multiply.  Any other exit ends it.
            log_eps = math.log(self.epsilon)
            log_reduction = 0.0
            it = 0
            rhs = f
            patience = 5
            stage1_executed = 1
            for stage_index in range(3):
                best_res, res0, best_it, best_u, stage_executed = stage_solve(u0, rhs, omegas)
                self._consecutive_device_failures = 0
                if stage_index == 0:
                    stage1_executed = max(1, stage_executed)
                res0 = float(res0)
                best_res = float(best_res)
                if best_it == 0 or res0 <= 0.0 or not math.isfinite(best_res):
                    break
                ratio = best_res / res0
                if ratio >= 1.0:
                    break
                log_reduction += math.log(max(ratio, 1e-300))
                it += best_it
                stalled = (stage_executed - best_it) >= patience
                target_hit = best_res <= self.measure_reduction * res0
                if log_reduction <= log_eps or not (stalled or target_hit):
                    break
                try:
                    r64 = self._host_residual(
                        operator,
                        tuple(x.cpu().numpy().astype(np.float64) for x in best_u),
                        tuple(x.cpu().numpy().astype(np.float64) for x in rhs),
                    )
                except NotImplementedError:
                    break
                rhs = self._to_device(r64)
        except _DEVICE_ERRORS:
            raise
        except (RuntimeError, ValueError, NotImplementedError, FloatingPointError):
            return infinity, infinity, infinity

        if it == 0 or not math.isfinite(log_reduction):
            return infinity, infinity, infinity
        rho = math.exp(log_reduction / it)
        if not math.isfinite(rho):
            return infinity, infinity, infinity
        if rho >= 1.0:
            return infinity, rho, self.iteration_limit
        iterations = int(math.ceil(math.log(self.epsilon) / math.log(rho)))
        if iterations > self.iteration_limit:
            # Cap breach: time poisoned, ρ and the extrapolated count kept.
            return infinity, rho, iterations
        times = sorted(
            self._timed_stage(stage_solve, u0, f, omegas)
            for _ in range(max(1, evaluation_samples))
        )
        self.run_time_total += sum(times)
        # Normalised by the executed iterations of the first stage.
        t_iter_ms = 1e3 * times[len(times) // 2] / stage1_executed
        return iterations * t_iter_ms, rho, iterations

    def generate_and_evaluate_group(
        self, expressions, infinity=1e100, evaluation_samples=3,
        global_variable_values=None,
    ):
        """Evaluation of same-structure individuals (counterpart of the
        reference's group path, evostencils_tpu/backend/evaluation.py:703).

        All expressions share the ω-parameterized structural key.  Each
        member's ρ is its own float32 power iteration, as
        `generate_and_evaluate` computes it; the time per iteration is
        measured once, on the first member that survives, and every later
        survivor shares it.  The reference vmaps the power iteration over
        the group's ω in one dispatch; here it runs once per member.
        Returns a list of (time_to_convergence_ms, ρ, iterations) triples.
        """
        if global_variable_values:
            self._apply_parameter_values(global_variable_values)

        def one_by_one():
            return [
                self.generate_and_evaluate(
                    e, infinity=infinity, evaluation_samples=evaluation_samples,
                    global_variable_values=global_variable_values,
                )
                for e in expressions
            ]

        # The float64 measurement has no power iteration to share.
        if (getattr(self.problem, "outer_solver", None) or self.uses_FAS()
                or self._np_dtype != np.float32):
            return one_by_one()
        try:
            (stage_solve, power_solve, _), omega_arg0 = self._build_solver(expressions[0])
            if isinstance(omega_arg0, Program):
                # Same-structure programs share opcodes; each member brings
                # its own ω.
                vm = self._vms[self._expression_level(expressions[0])]
                omega_args = []
                for e in expressions:
                    program = vm.translate(e)
                    if program is None or not np.array_equal(program.opcodes, omega_arg0.opcodes):
                        raise RuntimeError("no group path")
                    omega_args.append(program)
            else:
                omega_args = [self._omega_vector(e) for e in expressions]
            if len(expressions) > GROUP_SIZE_LIMIT:
                # As the reference: the halves drop global_variable_values.
                return self.generate_and_evaluate_group(
                    expressions[:GROUP_SIZE_LIMIT], infinity, evaluation_samples
                ) + self.generate_and_evaluate_group(
                    expressions[GROUP_SIZE_LIMIT:], infinity, evaluation_samples
                )
            u0, f, e0, zf = self._probe_state(expressions[0])
            rates = [float(power_solve(e0, zf, w)[0]) for w in omega_args]
            self._consecutive_device_failures = 0
            self.groups += 1
            self.group_members += len(expressions)
        except (RuntimeError, ValueError, TypeError, NotImplementedError, FloatingPointError):
            return one_by_one()

        results = []
        t_iter_ms = None
        for omegas, rate in zip(omega_args, rates):
            rho, iterations, result = self._power_verdict(rate, infinity)
            if result is not None:
                results.append(result)
                continue
            if t_iter_ms is None:
                try:
                    t_iter_ms = self._time_per_iteration_ms(
                        stage_solve, u0, f, omegas, evaluation_samples)
                except _DEVICE_ERRORS:
                    self._device_failed()
                    results.append((infinity, rho, iterations))
                    continue
            results.append((iterations * t_iter_ms, rho, iterations))
        return results

    def evaluate_objectives(self, expression, evaluation_samples=3, infinity=1e100):
        """(ρ, time_per_iteration_ms): the NSGA-II objective pair."""
        t, rho, iterations = self.generate_and_evaluate(
            expression, infinity=infinity, evaluation_samples=evaluation_samples
        )
        if not math.isfinite(t) or t >= infinity:
            return rho, infinity
        return rho, t / iterations

    def _host_residual(self, operator, u_fields, f_fields):
        """Exact float64 residual f − A·u on the host."""
        out = []
        for i, row in enumerate(operator.entries):
            acc = np.array(f_fields[i], dtype=np.float64)
            for entry, u in zip(row, u_fields):
                if isinstance(entry, base.ZeroOperator):
                    continue
                gen = getattr(entry, "stencil_generator", None)
                if gen is not None and (
                    getattr(gen, "is_nonlinear", False)
                    or getattr(gen, "is_variable", lambda: False)()
                ):
                    raise NotPortedError("host residual of non-constant operators")
                stencil = entry.generate_stencil()
                if isinstance(stencil, periodic.PeriodicStencil):
                    if not stencil.is_uniform():
                        # As the reference: no exact residual, the
                        # measurement ends after this stage.
                        raise NotImplementedError("host residual: periodic entry")
                    stencil = stencil.as_constant()
                acc -= sops.numpy_apply_constant_stencil(np.asarray(u, np.float64), stencil)
            out.append(acc)
        return out
