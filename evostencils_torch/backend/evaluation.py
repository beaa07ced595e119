"""Fitness evaluation of evolved cycles in torch (counterpart of
evostencils_tpu/backend/evaluation.py; real and complex dtypes, with the
outer Krylov solve and the k-ladder of Helmholtz).

`TorchProgramGenerator` implements the optimizer-facing protocol of the
reference's `JaxProgramGenerator` and measures the same fitness: ρ, time
to the residual target and the iteration count, with infinity for
failures.
  * float32, complex64: ρ from a power iteration on the error-propagation
    operator (blocks of 10 cycles, renormalised every cycle, 3 to 8
    blocks, a 2 % stopping rule); iterations = ⌈log ε / log ρ⌉; time per
    cycle from the residual-driven stage solve.
  * float64, complex128: residual-driven stages, restarted from the exact
    host-f64 (complex128) residual when a stage stalls at its floor.
  * a FAS problem (nonlinear operator): no power iteration and no cycle
    VM; one residual-driven stage to the measurement target, with no
    restart (a restart from a host residual assumes a linear cycle).
  * a problem with an `outer_solver` (Helmholtz): the cycle preconditions
    BiCGStab on the outer operator; the fitness is the outer iteration
    count to the true target, reached in at most 4 stages that restart
    from the exact host residual, after a short probe solve that kills
    hopeless preconditioners.  `global_variable_values={"k": ...}`
    evaluates the ladder k, 2k, 4k and averages.

`generate_and_evaluate_group` scores same-structure individuals (the
optimizer's ω-mutation offspring) as the reference's group path does: the
members' float32 power iterations as one batched loop over a member axis
(`BatchedPowerLoop`, the counterpart of the reference's vmapped
`power_raw`), padded to a bucket of 2, 4, 8 or 16 members; one time per
iteration measured on the first survivor and shared.

The generator runs on the card unless the caller asks for the CPU
(`device="cpu"`).  The reference's device loops (`lax.while_loop`) are
host loops here around a cycle and glue bodies on the device: `StageLoop`
(a cycle, then its residual norm and the best-iterate update), `PowerLoop`
(ten cycles, each renormalised, then the block's rate) and
`krylov.BicgstabLoop` (one outer iteration, glue around its two
preconditioner cycles).  The host reads one value per cycle or block, the
residual norm or the block's rate, and decides in the tensor's dtype as
the reference does on the device, so the executed count and the exit
reason match.  On a card (backend/graphs.py, `cuda_graphs=True`, the
default there) a VM program's cycle runs on its problem's
`graphs.Interpreter`, one graph per ISA branch replayed in program order,
and the glue around it is captured once per problem hierarchy: the
counterpart of the reference's one interpreter executable, so a new
structure costs no capture (but for a branch's first use), and the time
objective counts the device's work and the replays, not the host's walk
of the cycle.  A lowered cycle (`StepCycle`) and its loops' glue are
captured per structure, as the reference compiles a lowered structure per
structure.  A FAS cycle is a lowered step too: it takes no VM, as in the
reference, but the reference still compiles its stage per structure, and
so its stage loop is captured per structure here.  `cuda_graphs=False`
runs the same bodies eagerly, the cycle through `CycleVM.make_step` or the
lowered step.  Explicit rules keep these eager: the CPU (no graphs) and a
device mesh (its transfers cannot be captured).  Times are CUDA-event
spans on a GPU and `perf_counter` spans on the CPU.

`TorchProgramGenerator(problem, mesh=...)` evaluates on a (dp, sp) device
mesh (parallel/mesh.py), one process per rank, every rank of an `sp` group
calling it for the same individuals in the same order: the state is split
by rows over `sp`, and by default the same on every `dp` row (the
reference's P("sp", None)); under MultiHostDispatcher(layout=...) the `dp`
rows evaluate different individuals.  The probe state is
made whole and cut, so a sharded run starts from the unsharded run's
state; every norm and inner product a loop decides on is all-reduced over
`sp` (the outer BiCGStab's too); the 64-bit host residual gathers the
slabs and cuts its result; and every measured time is the largest over the
ranks that evaluate the individual, so every rank scores, and breeds,
alike.  Every family runs under a mesh, in every dtype: 2D and 3D Poisson,
variable coefficients, elasticity, FAS (one stage on slabs) and Helmholtz
(the probe, the outer stages and the k-ladder, with the cycle on slabs as
the preconditioner).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from evostencils_torch import dtype_is_64bit, dtype_is_complex, numpy_dtype
from evostencils_torch.backend import graphs
from evostencils_torch.backend.graphs import StepCycle
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.backend.vm import CycleVM, Program, batched_program
from evostencils_torch.ir import base, system
from evostencils_torch.ir.transformations import canonical_string, collect_cycles
from evostencils_torch.ops import krylov
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.parallel.mesh import gather_state
from evostencils_torch.stencils import periodic
from evostencils_torch.utils import profiling

# A power-iteration rate of exactly 0.0 is an f32 underflow of a superb
# cycle's error norm — clamp to a finite, best-ordered value.
ZERO_RATE_CLAMP = 1e-16

# The reference's group buckets: a group of n runs padded to the smallest
# bucket that holds it, and a larger group is split at the largest.
GROUP_BUCKETS = (2, 4, 8, 16)

# Device faults that poison one individual (a run of them aborts); checked
# before the RuntimeError family they belong to.
_DEVICE_ERRORS = (torch.cuda.OutOfMemoryError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()
)
# A failed transfer between ranks ends the run on every rank: it is not a
# bad individual (also a RuntimeError).
_RANK_ERRORS = (torch.distributed.DistError,)


def _host_norm(state) -> float:
    """Euclidean norm of a host (numpy) state."""
    return math.sqrt(sum(float(np.sum(np.abs(x) ** 2)) for x in state))


def _real_scalar(like, shape=()) -> torch.Tensor:
    """A 0-d zero (or zeros of `shape`) of the state's real dtype on its
    device."""
    return torch.zeros(shape, dtype=like.real.dtype, device=like.device)


def group_bucket(n: int) -> int:
    """The members a group of n runs as: the next power of two, at least
    2 and at most the largest bucket (evostencils_tpu/backend/
    evaluation.py:755-768)."""
    bucket = GROUP_BUCKETS[0]
    while bucket < n:
        bucket *= 2
    return min(bucket, GROUP_BUCKETS[-1])


def _cycle_parts(cycle) -> tuple:
    """The cycle as a part captured with its loop: a StepCycle is; an
    Interpreter captures its own graphs."""
    return (cycle,) if isinstance(cycle, graphs.Loop) else ()


class StageLoop(graphs.Loop):
    """The body of the reference's `stage_raw` around a cycle (StepCycle or
    graphs.Interpreter) whose finest level holds the iterate and the
    right-hand side: `start` takes the residual norm of the loaded state;
    `step()` runs one cycle and then `post`, its residual norm and the
    best-iterate update (`torch.where` into `best_u`, `best_res`,
    `best_it`), as the reference's `while_loop` body does on the device."""

    bodies = ("start", "post")

    def __init__(self, cycle, residual_norm):
        super().__init__()
        self.cycle, self.residual_norm = cycle, residual_norm
        self.lock = cycle.lock
        like = cycle.u
        self.best_u = sops.zeros_like_state(like)
        self.res, self.best_res = _real_scalar(like[0]), _real_scalar(like[0])
        self.it, self.best_it = (torch.zeros((), dtype=torch.int32, device=like[0].device)
                                 for _ in range(2))

    def parts(self) -> tuple:
        return _cycle_parts(self.cycle)

    def load(self, u0, rhs, omega_arg) -> None:
        for dst, src in ((self.cycle.u, u0), (self.cycle.f, rhs)):
            for d, x in zip(dst, src):
                d.copy_(x)
        self.cycle.load(omega_arg)

    def start(self) -> None:
        res0 = self.residual_norm(self.cycle.u, self.cycle.f)
        self.res.copy_(res0)
        self.best_res.copy_(res0)
        self.it.zero_()
        self.best_it.zero_()
        for b, x in zip(self.best_u, self.cycle.u):
            b.copy_(x)

    def step(self) -> None:
        self.cycle.run_cycle()
        self.run("post")

    def post(self) -> None:
        u = self.cycle.u
        res = self.residual_norm(u, self.cycle.f)
        self.it.add_(1)
        improved = res < self.best_res
        self.best_it.copy_(torch.where(improved, self.it, self.best_it))
        for b, x in zip(self.best_u, u):
            b.copy_(torch.where(improved, x, b))
        self.best_res.copy_(torch.where(improved, res, self.best_res))
        self.res.copy_(res)


class PowerLoop(graphs.Loop):
    """One block of the reference's `power_raw` around a cycle: ten cycles
    on the error with f ≡ 0, each followed by `renormalise` (the error
    divided by its norm, the norm's log accumulated), then `block_rate`,
    the block's per-cycle rate from the accumulated log-norms (a block rate
    of ρ^10 underflows float32 for very fast cycles)."""

    bodies = ("renormalise", "block_rate")
    BLOCK_LEN = 10

    def __init__(self, cycle, norm):
        super().__init__()
        self.cycle, self.norm = cycle, norm
        self.lock = cycle.lock
        self.log_acc, self.rate = _real_scalar(cycle.u[0]), _real_scalar(cycle.u[0])

    def parts(self) -> tuple:
        return _cycle_parts(self.cycle)

    def load(self, e0, zf, omega_arg) -> None:
        for dst, src in ((self.cycle.u, e0), (self.cycle.f, zf)):
            for d, x in zip(dst, src):
                d.copy_(x)
        self.cycle.load(omega_arg)
        self.log_acc.zero_()

    def block(self) -> None:
        for _ in range(self.BLOCK_LEN):
            self.cycle.run_cycle()
            self.run("renormalise")
        self.run("block_rate")

    def renormalise(self) -> None:
        e = self.cycle.u
        n = self.norm(e)
        tiny = torch.finfo(n.dtype).tiny
        safe = torch.where(n > 0, n, 1.0)
        for x in e:
            x.copy_(x / safe)
        self.log_acc.add_(torch.log(torch.where(n > 0, n, tiny)))

    def block_rate(self) -> None:
        self.rate.copy_(torch.exp(self.log_acc / self.BLOCK_LEN))
        self.log_acc.zero_()


class BatchedPowerLoop(PowerLoop):
    """PowerLoop over a member axis (the counterpart of the reference's
    vmapped `power_raw`): the cycle's state is shaped (B, *grid), `norm`
    gives one norm per member, each member is divided by its own norm and
    accumulates its own log, and `rate` holds B block rates.  A member's
    arithmetic is the single loop's on that member."""

    def __init__(self, cycle, norm):
        graphs.Loop.__init__(self)
        self.cycle, self.norm = cycle, norm
        self.lock = cycle.lock
        like = cycle.u[0]
        self.log_acc, self.rate = _real_scalar(like, like.shape[:1]), _real_scalar(
            like, like.shape[:1])

    def renormalise(self) -> None:
        e = self.cycle.u
        n = self.norm(e)
        tiny = torch.finfo(n.dtype).tiny
        safe = sops.per_member(torch.where(n > 0, n, 1.0), e[0])
        for x in e:
            x.copy_(x / safe)
        self.log_acc.add_(torch.log(torch.where(n > 0, n, tiny)))


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
        ladder_rungs: int = 3,
        mesh=None,
        replicate_below: int = 64,
        cuda_graphs: Optional[bool] = None,
    ):
        self.problem = problem
        self.device = torch.device(device)
        # The measurement loops' bodies run from CUDA graphs (the default on
        # a card without a mesh), or eagerly.
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda" and mesh is None
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs: no CUDA graphs on {self.device}")
        if cuda_graphs and mesh is not None:
            raise ValueError("cuda_graphs: a device mesh runs eagerly (its transfers "
                             "between ranks cannot be captured)")
        self.graph_cache = graphs.GraphCache() if cuda_graphs else None
        # Rungs of the k-ladder per Helmholtz fitness (k, 2k, 4k).  One
        # rung during evolution keeps the selection pressure on the base
        # k; champions are then validated on the full ladder
        # (scripts/torch_evaluate_helmholtz_ladder.py).
        self.ladder_rungs = max(1, int(ladder_rungs))
        self.dtype = dtype if dtype is not None else problem.dtype
        self._np_dtype = numpy_dtype(self.dtype)
        is_f64 = dtype_is_64bit(self.dtype)
        # Residual norms and rates are real; the host accumulates exact
        # residuals in float64 or complex128.
        self._np_real = np.float64 if is_f64 else np.float32
        self._np_acc = np.complex128 if dtype_is_complex(self.dtype) else np.float64
        self.epsilon = epsilon if epsilon is not None else problem.residual_target
        self.iteration_limit = (
            iteration_limit if iteration_limit is not None else problem.iteration_limit
        )
        if measure_reduction is None:
            # 64-bit dtypes measure the full target in one stage; 32-bit
            # ones in stage windows of 1e-4, well above their floor.
            measure_reduction = self.epsilon if is_f64 else max(self.epsilon, 1e-4)
        self.measure_reduction = measure_reduction
        self.lowering = CycleLowering(
            self.dtype, self.device, mesh=mesh, replicate_below=replicate_below)
        self.layout = self.lowering.layout
        self._solver_cache = {}
        self._vms = {}
        # The interpreter on CUDA graphs of each VM (backend/graphs.py).
        self._interpreters = {}
        # Solver construction (VM opcodes, solver caches, hit counts) is
        # shared state: concurrent evaluations (parallel/dispatch.py) build
        # one at a time and run their solves unlocked.
        self._build_lock = threading.RLock()
        self.run_time_total = 0.0
        # Seeded right-hand side / initial guess for sample-spread
        # re-measurement (Problem.initial_state).
        self.rhs_seed = None
        self.init_seed = None
        self._consecutive_device_failures = 0
        # How many solver builds took the cycle-VM path vs IR lowering, the
        # misses a program too long for the largest pad class caused, and
        # the solvers a lazily registered branch made anew (the reference's
        # interpreter recompiles).
        self.vm_hits = 0
        self.vm_misses = 0
        self.vm_pad_overflows = 0
        self.vm_isa_recompiles = 0
        # The opcode sequences of the VM programs evaluated.
        self._vm_structures = set()
        # Groups scored by generate_and_evaluate_group, and their members
        # (members of a group that fell back one by one are not counted);
        # the part of them whose power iterations ran as one batched loop.
        self.groups = 0
        self.group_members = 0
        self.groups_batched = 0
        self.batched_members = 0
        # Wall seconds spent in generate_and_evaluate_group.
        self.group_s = 0.0
        # The batched group path's interpreters, one per (VM, bucket).
        self._batched_interpreters = {}
        # What the last outer-Krylov evaluation did: the probe's verdict
        # ("skipped", "killed", "survived": the staged solve went on from its
        # iterate, or "unused": it reduced nothing), its iterations and the
        # number of full-cap stages that ran.
        self.last_outer_solve = None
        # What the last cycle evaluation ran: the power iteration's cycles
        # and the cycles each stage solve executed (the timed solve's first
        # run included, its timing samples not).
        self.last_cycle_solve = None

    def vm_stats(self) -> dict:
        total = self.vm_hits + self.vm_misses
        return {
            "vm_hits": self.vm_hits,
            "vm_misses": self.vm_misses,
            "vm_pad_overflows": self.vm_pad_overflows,
            "vm_isa_recompiles": self.vm_isa_recompiles,
            "vm_hit_rate": (self.vm_hits / total) if total else None,
        }

    def graph_stats(self) -> dict:
        """What the VM path's CUDA graphs did: its captures (the
        interpreters' prologues and branches, and the glue of the loops
        around them), the branches registered in the ISAs that run on
        graphs (NOP takes none), the glue bodies that exist, and the
        distinct structures evaluated through the VM.  A new structure
        captures only branches it is the first to use, so `vm_captures` ≤
        `branches_registered` + `glue_bodies` however many structures
        there are.  `lowered_captures`: the per-structure graphs of the
        lowered path."""
        cache = self.graph_cache
        entries = [] if cache is None else list(cache._entries.items())
        interpreters = list(self._interpreters.items()) + [
            (vm, i) for (vm, _), i in self._batched_interpreters.items()]
        buckets = {}
        for (_, members), interpreter in self._batched_interpreters.items():
            bucket = buckets.setdefault(members, {"captures": 0, "bytes": 0})
            bucket["captures"] += interpreter.captures
            bucket["bytes"] += interpreter.nbytes
        for key, loop in entries:
            if key[-2] == "power" and isinstance(key[-1], int):
                bucket = buckets.setdefault(key[-1], {"captures": 0, "bytes": 0})
                bucket["captures"] += loop.captures
                bucket["bytes"] += loop.nbytes
        return {
            "vm_captures": (sum(i.captures for _, i in interpreters)
                            + (cache.captures["__vm__"] if cache is not None else 0)),
            "branches_registered": sum(len(vm._branches) - 1 for vm, _ in interpreters),
            "glue_bodies": len(interpreters) + sum(
                len(loop.bodies) for key, loop in entries if key[0] == "__vm__"),
            "structures": len(self._vm_structures),
            "lowered_captures": 0 if cache is None else sum(
                n for kind, n in cache.captures.items() if kind != "__vm__"),
            # The batched group path by bucket: its interpreters' graphs and
            # its power loops' (glue, or a lowered structure's cycle and
            # glue), and the bytes they hold.
            "buckets": {members: buckets[members] for members in sorted(buckets)},
        }

    @property
    def _param_sig(self):
        """Hashable signature of the PDE parameters: solvers and VMs are
        kept per value, so a k-ladder that revisits the same k for every
        individual reuses them."""
        return tuple(sorted(
            (k, v) for k, v in self.problem.parameters.items()
            if isinstance(v, (int, float, complex))
        ))

    def _apply_parameter_values(self, values) -> None:
        """Switch the problem's PDE parameters; caches stay (keyed by
        signature)."""
        if any(self.problem.parameters.get(k) != v for k, v in values.items()):
            self.problem = self.problem.with_parameters(values)

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
        self._interpreters.clear()
        self._batched_interpreters.clear()
        if self.graph_cache is not None:
            self.graph_cache.clear()

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
        (vm, None) on a translation miss; (None, None) for FAS or a single
        level."""
        if self.uses_FAS():
            return None, None
        level = self._expression_level(expression)
        if level - self.problem.min_level + 1 < 2:
            return None, None
        vm = self._vm_for(level)
        return vm, vm.translate(expression)

    def _vm_for(self, level: int):
        key = (self._param_sig, level)
        vm = self._vms.get(key)
        if vm is None:
            # Outer-Krylov problems take the reference's slim ISA: block
            # smoothers fail translation and are lowered from the IR.
            slim = getattr(self.problem, "outer_solver", None) is not None
            vm = CycleVM(self.lowering, self.problem, level, include_block_smoothers=not slim)
            self._vms[key] = vm
        return vm

    def _vm_key(self, vm, program, expression, tag=()):
        """The solver key of a VM program, ("__vm__", param_sig, level,
        isa_version) + tag, as the reference keys its interpreter: one per
        problem hierarchy and ISA, whatever the structure.  A new key at a
        level that already has one counts as an ISA recompile (the
        reference's rule, evostencils_tpu/backend/evaluation.py:615-626)."""
        base = ("__vm__", self._param_sig, self._expression_level(expression))
        key = base + (vm.isa_version,) + tag
        self._vm_structures.add(program.opcodes[:program.length].tobytes())
        if key not in self._solver_cache and not tag and any(
                isinstance(k, tuple) and k[:3] == base for k in self._solver_cache):
            self.vm_isa_recompiles += 1
        return base, key

    def _vm_missed(self, vm) -> None:
        self.vm_misses += 1
        if vm is not None and vm.last_failure == "pad_overflow":
            self.vm_pad_overflows += 1

    def _build_solver(self, expression):
        """((stage, power, operator), omega_arg): the measurement functions
        around the cycle VM's step when the expression translates, else
        around the IR-lowered step.  `omega_arg` is the VM Program or the
        relaxation factors as float32 (the reference's traced ω vector)."""
        with profiling.span("evaluate.build"), self._build_lock:
            vm, program = self._vm_program(expression)
            if program is not None:
                self.vm_hits += 1
                base, key = self._vm_key(vm, program, expression)
                if key not in self._solver_cache:
                    operator = self._finest_operator_for(expression)
                    self._solver_cache[key] = self._stage_power_fns(
                        vm.make_step(), operator, base) + (operator,)
                return self._solver_cache[key], program
            self._vm_missed(vm)
            omega_values = self._omega_vector(expression)
            key = self._structural_key(expression)
            if key not in self._solver_cache:
                step = self.lowering.lower_parameterized(expression)[0]
                operator = self._finest_operator_for(expression)
                self._solver_cache[key] = self._stage_power_fns(step, operator, key) + (
                    operator,)
            return self._solver_cache[key], omega_values

    def _structural_key(self, expression, prefix: str = "solve"):
        return (prefix, self._param_sig,
                canonical_string(expression, parameterize_relaxation=True))

    @staticmethod
    def _omega_vector(expression) -> np.ndarray:
        """The relaxation factors in canonical slot order, as float32."""
        return np.asarray(
            [float(c.relaxation_factor) for c in collect_cycles(expression)], dtype=np.float32
        )

    def _interpreter(self, vm, members: Optional[int] = None) -> graphs.Interpreter:
        """The VM's interpreter, or with `members` its batched one for that
        bucket."""
        with self._build_lock:
            if members is not None:
                interpreter = self._batched_interpreters.get((vm, members))
                if interpreter is None:
                    interpreter = self._batched_interpreters[(vm, members)] = (
                        graphs.Interpreter(vm.make_state(members)))
                return interpreter
            interpreter = self._interpreters.get(vm)
            if interpreter is None:
                interpreter = self._interpreters[vm] = graphs.Interpreter(vm.make_state())
            return interpreter

    def _loop(self, key, step, omega_arg, like, make, members: Optional[int] = None):
        """The measurement loop make(cycle) under `key`.  Eagerly (no graph
        cache): a new loop around StepCycle(step).  On CUDA
        graphs, a VM program's loop runs on its VM's Interpreter, its glue
        captured once per problem hierarchy (under the interpreter's lock:
        the warm-ups write its state); a lowered step's loop runs on a
        StepCycle of its own, captured with it per structure.  `members`:
        the batched loop of a group bucket, on that bucket's interpreter."""
        if self.graph_cache is None:
            return make(StepCycle(step, omega_arg, like))
        vm = getattr(step, "vm", None)
        if vm is None or not isinstance(omega_arg, Program):
            return self.graph_cache.get(key, lambda: make(StepCycle(step, omega_arg, like)))
        interpreter = self._interpreter(vm, members)
        with interpreter.lock:
            return self.graph_cache.get(key, lambda: make(interpreter))

    def _stage_power_fns(self, step, operator, key):
        """The two measurement loops around step(u, f, omega_arg): the
        residual-driven stage solve and the error-propagation power
        iteration; `key` is the one their graphs are kept under: the
        problem hierarchy's for a VM step, the structure's for a lowered
        one."""
        lowering = self.lowering
        cap = self.iteration_limit
        np_dt = self._np_real
        target = np_dt(self.measure_reduction)
        # Pace rule: surviving poisoning needs ρ ≤ ε^(1/cap); 10× behind
        # that pace after 25 cycles, a stage stops.
        rho_required = np_dt(self.epsilon ** (1.0 / cap))
        grace = np_dt(10.0)
        divergence = np_dt(1e8)
        # Stall patience: at the f32 residual floor the best point so far
        # defines the stage's reduction.
        patience = 5

        # The finest grid's slab on a mesh: its norms are all-reduced, so
        # every rank reads the same value and takes the same branch.
        slab = lowering._slab(operator.grid[0])

        def residual_norm(u, f):
            return sops.l2_norm(sops.tree_sub(f, lowering.system_apply(operator, u)), slab)

        def norm(e):
            return sops.l2_norm(e, slab)

        def member_norms(e):
            return sops.l2_norm(e, slab, members=True)

        def going(k, prev_rate, rate):
            """The power iteration's `cond`, for one rate or one per member."""
            with np.errstate(invalid="ignore", over="ignore"):
                return ((k < 8) & ((k < 3) | (np.abs(rate - prev_rate) > np_dt(0.02) * np.abs(rate)))
                        & (rate < 2.0) & np.isfinite(rate))

        def stage(u0, rhs, omega_arg):
            """(best_res, res0, best_it, best_u, executed); the exit test is
            the reference's device test, evaluated in the tensor's dtype on
            one residual norm read back per cycle.  best_u is a copy."""
            loop = self._loop(key + ("stage",), step, omega_arg, u0,
                              lambda cycle: StageLoop(cycle, residual_norm))
            with profiling.span("loop.stage"), loop.lock:
                loop.load(u0, rhs, omega_arg)
                loop.run("start")
                res0 = np_dt(graphs.read(loop.res))
                res, it, best_res, best_it = res0, 0, res0, 0
                while (
                    it < cap
                    and res > target * res0
                    and res < divergence * res0
                    and np.isfinite(res)
                    and (it < 25 or res < grace * res0 * rho_required ** np_dt(it))
                    and it - best_it < patience
                ):
                    loop.step()
                    res = np_dt(graphs.read(loop.res))
                    it += 1
                    if res < best_res:
                        best_it, best_res = it, res
                return (np_dt(graphs.read(loop.best_res)), res0, int(graphs.read(loop.best_it)),
                        tuple(x.clone() for x in loop.best_u), it)

        def power(e0, zf, omega_arg):
            """(rate, cycles): blocks until the per-cycle rate settles."""
            loop = self._loop(key + ("power",), step, omega_arg, e0,
                              lambda cycle: PowerLoop(cycle, norm))
            with profiling.span("loop.power"), loop.lock:
                loop.load(e0, zf, omega_arg)
                loop.block()
                rate = np_dt(graphs.read(loop.rate))
                prev_rate, k = np_dt(0.0), 1
                while going(k, prev_rate, rate):
                    loop.block()
                    prev_rate, rate, k = rate, np_dt(graphs.read(loop.rate)), k + 1
            return rate, k * PowerLoop.BLOCK_LEN

        def batched_power(e0, zf, omega_arg):
            """(rates, cycles), one of each per member: the power iteration
            of B members (e0, zf shaped (B, *grid), `omega_arg` one row of ω
            per member) as one loop, one read of the B rates a block.  Each
            member is held to `cond` on its own; a member whose `cond` ends
            keeps the rate and the block count it had there, as the
            reference's vmap of `while_loop` freezes a finished member's
            carry, and the loop runs until no member goes on."""
            members = e0[0].shape[0]
            loop = self._loop(key + ("power", members), step, omega_arg, e0,
                              lambda cycle: BatchedPowerLoop(cycle, member_norms), members)
            with profiling.span("loop.power"), loop.lock:
                loop.load(e0, zf, omega_arg)
                loop.block()
                rate = graphs.read(loop.rate).astype(np_dt)
                prev_rate, k = np.zeros_like(rate), np.ones(members, dtype=np.int64)
                active = going(k, prev_rate, rate)
                while active.any():
                    loop.block()
                    new_rate = graphs.read(loop.rate).astype(np_dt)
                    prev_rate = np.where(active, rate, prev_rate)
                    rate = np.where(active, new_rate, rate)
                    k += active
                    active &= going(k, prev_rate, rate)
            return rate, k * PowerLoop.BLOCK_LEN

        # The group path's batched form of the same power iteration.
        power.batched = batched_power
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

    def _timed(self, solve, *args) -> float:
        """Seconds one solve(*args) takes on the device: a CUDA-event span
        on a GPU, which ends when the device has finished.  On a mesh the
        largest span of all ranks, so that every rank's fitness is the
        same."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solve(*args)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            solve(*args)
            seconds = time.perf_counter() - t0
        if self.layout is not None:
            seconds = self.layout.all_reduce_max(seconds, self.device)
        return seconds

    def _median_time(self, solve, args, evaluation_samples) -> float:
        """Median seconds of solve(*args) over `evaluation_samples` runs."""
        with profiling.span("evaluate.timing"):
            times = sorted(self._timed(solve, *args) for _ in range(max(1, evaluation_samples)))
        self.run_time_total += sum(times)
        return times[len(times) // 2]

    def _to_host(self, state, grids=None):
        """A device state in the host accumulation dtype; on a mesh the whole
        fields of `grids`, gathered from the slabs."""
        if self.layout is not None:
            state = gather_state(state, [g.interior_shape for g in grids], self.layout)
        return tuple(x.cpu().numpy().astype(self._np_acc) for x in state)

    def _to_device(self, host_state):
        """Whole host fields on the device; on a mesh this rank's rows."""
        out = []
        for x in host_state:
            x = np.asarray(x)
            slab = None if self.layout is None else self.layout.slab(x.shape)
            x = x if slab is None else slab.cut(x)
            out.append(torch.from_numpy(np.ascontiguousarray(x, dtype=self._np_dtype)).to(
                self.device))
        return tuple(out)

    def _probe_state(self, expression):
        """(u0, f, e0, zf) on the device at the expression's level: the
        problem's initial state, the power iteration's seeded random error
        and its zero right-hand side."""
        with profiling.span("evaluate.probe_state"):
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
        executed = stage_solve(u0, f, omegas)[4]
        if self.last_cycle_solve is not None:
            self.last_cycle_solve["stage_executed"].append(executed)
        return (1e3 * self._median_time(stage_solve, (u0, f, omegas), evaluation_samples)
                / max(1, executed))

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
        with profiling.span("evaluate", root=True):
            if global_variable_values:
                self._apply_parameter_values(global_variable_values)
                if "k" in global_variable_values and getattr(self.problem, "outer_solver", None):
                    # The Helmholtz protocol: every individual across the
                    # k-ladder k, 2k, 4k.
                    return self._evaluate_k_ladder(expression, infinity, evaluation_samples)
            return self._generate_and_evaluate_measured(expression, infinity, evaluation_samples)

    def _evaluate_k_ladder(self, expression, infinity, evaluation_samples):
        """k, 2k, 4k with the reference's combination rule: the mean over
        the rungs; on a failing rung the sums so far, at once, which keeps
        failures ordered behind successes.  The base k is restored."""
        base_k = self.problem.parameters["k"]
        rungs = self.ladder_rungs
        total_t = total_rho = total_it = 0.0
        try:
            for i in range(rungs):
                t, rho, it = self._generate_and_evaluate_measured(
                    expression, infinity, evaluation_samples)
                total_t += t
                total_rho += rho
                total_it += it
                if not math.isfinite(t) or t >= infinity or rho > 1:
                    return total_t, total_rho, total_it
                if i < rungs - 1:
                    self._apply_parameter_values({"k": self.problem.parameters["k"] * 2.0})
        finally:
            self._apply_parameter_values({"k": base_k})
        return total_t / rungs, total_rho / rungs, total_it / rungs

    def _generate_and_evaluate_measured(self, expression, infinity, evaluation_samples):
        """One measurement at the current parameters; a device fault
        poisons this individual (a run of them aborts)."""
        if getattr(self.problem, "outer_solver", None):
            evaluate = self._generate_and_evaluate_outer
        else:
            evaluate = self._generate_and_evaluate_cycle
        try:
            return evaluate(expression, infinity, evaluation_samples)
        except _RANK_ERRORS:
            raise
        except _DEVICE_ERRORS:
            self._device_failed()
            return infinity, infinity, infinity

    def _generate_and_evaluate_cycle(self, expression, infinity, evaluation_samples):
        record = self.last_cycle_solve = {"power_cycles": 0, "stage_executed": []}
        try:
            (stage_solve, power_solve, operator), omegas = self._build_solver(expression)
            u0, f, e0, zf = self._probe_state(expression)

            linear = not self.uses_FAS()
            if linear and not dtype_is_64bit(self.dtype):
                # ρ by power iteration on the error-propagation operator.
                rate, record["power_cycles"] = power_solve(e0, zf, omegas)
                self._consecutive_device_failures = 0
                rho, iterations, result = self._power_verdict(float(rate), infinity)
                if result is not None:
                    return result
                t_iter_ms = self._time_per_iteration_ms(
                    stage_solve, u0, f, omegas, evaluation_samples)
                return iterations * t_iter_ms, rho, iterations

            # Restarted measurement: when a stage stalls at its residual
            # floor before the target, the exact 64-bit host residual is
            # the next stage's right-hand side (the error equation), so
            # stage reductions multiply.  Any other exit ends it, and a
            # FAS cycle runs exactly one stage.
            log_eps = math.log(self.epsilon)
            log_reduction = 0.0
            it = 0
            rhs = f
            patience = 5
            stage1_executed = 1
            for stage_index in range(3):
                best_res, res0, best_it, best_u, stage_executed = stage_solve(u0, rhs, omegas)
                record["stage_executed"].append(stage_executed)
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
                if not linear or log_reduction <= log_eps or not (stalled or target_hit):
                    break
                try:
                    with profiling.span("host_residual"):
                        r64 = self._host_residual(
                            operator, self._to_host(best_u, operator.grid),
                            self._to_host(rhs, operator.grid))
                        rhs = self._to_device(r64)
                except NotImplementedError:
                    break
        except _DEVICE_ERRORS + _RANK_ERRORS:
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
        # Normalised by the executed iterations of the first stage.  A
        # device fault while timing poisons the time only: ρ and the count
        # are already measured.
        try:
            t_iter_ms = 1e3 * self._median_time(
                stage_solve, (u0, f, omegas), evaluation_samples) / stage1_executed
        except _DEVICE_ERRORS:
            self._device_failed()
            return infinity, rho, iterations
        return iterations * t_iter_ms, rho, iterations

    # ---- outer-Krylov (Helmholtz) evaluation ----

    def _outer_operator_for(self, expression):
        grids = expression.grid if isinstance(expression.grid, list) else [expression.grid]
        factory = self.problem.outer_solver["operator_factory"]
        outer_entry = base.Operator(
            "A_outer", grids[0],
            factory(self._expression_level(expression), self.problem.parameters),
        )
        return system.Operator("A_outer", [[outer_entry]])

    def _outer_solve_raw(self, step, outer_operator, max_iterations, key=("outer",)):
        """solve(f, omegas) -> (x, res, res0, iterations): BiCGStab on the
        outer operator from a zero guess, one cycle on (0, ·) as the
        preconditioner; on a mesh every inner product and norm is summed
        over the finest grid's slabs.  Its iteration's graphs are kept under
        `key` (the problem hierarchy's for a VM step, the structure's for a
        lowered one): the probe and the full solve share them."""
        lowering = self.lowering
        slab = lowering._slab(outer_operator.grid[0])
        target = self.problem.outer_solver["target_reduction"]
        if not dtype_is_64bit(self.dtype):
            # Per-stage device target: in float32/complex64 the residual
            # recurrence floors near 1e-6 to 1e-7 relative, so each stage
            # solves to 1e-6 and _generate_and_evaluate_outer restarts from
            # the exact host residual until the true target is met.
            target = max(target, 1e-6)

        def apply_a(state):
            return lowering.system_apply(outer_operator, state)

        def solve(f, omega_arg):
            res0 = float(graphs.read(sops.l2_norm(f, slab)))
            loop = self._loop(key + ("bicgstab",), step, omega_arg, f,
                              lambda cycle: krylov.BicgstabLoop(apply_a, cycle, f, slab))
            with loop.lock:
                loop.cycle.load(omega_arg)
                x, it, res = loop.solve(f, max_iterations, target)
            return x, res, res0, it

        return solve

    def _build_outer_solver(self, expression, probe_iterations=None):
        """((solve, outer_operator), omega_arg): the cycle as the
        preconditioner of BiCGStab on the outer operator, through the cycle
        VM when the cycle translates, else lowered from the IR.
        `probe_iterations` gives the short-capped variant of the
        prescreen, which counts as neither VM hit nor miss."""
        with profiling.span("evaluate.build"), self._build_lock:
            tag = "outer" if probe_iterations is None else f"outer_probe_{probe_iterations}"
            max_iterations = (
                self.problem.outer_solver["max_iterations"]
                if probe_iterations is None else probe_iterations
            )
            vm, program = self._vm_program(expression)
            if program is not None:
                if probe_iterations is None:
                    self.vm_hits += 1
                base_key, key = self._vm_key(vm, program, expression, (tag,))
                omega_arg, make_step = program, vm.make_step
            else:
                if probe_iterations is None:
                    self._vm_missed(vm)
                base_key = self._structural_key(expression, "outer")
                key = base_key + (tag,)
                omega_arg = self._omega_vector(expression)

                def make_step():
                    return self.lowering.lower_parameterized(expression)[0]

            if key not in self._solver_cache:
                outer_operator = self._outer_operator_for(expression)
                self._solver_cache[key] = (
                    self._outer_solve_raw(
                        make_step(), outer_operator, max_iterations, base_key + ("outer",)),
                    outer_operator,
                )
            return self._solver_cache[key], omega_arg

    def _generate_and_evaluate_outer(self, expression, infinity, evaluation_samples):
        """Outer-Krylov evaluation with restarts from the exact residual.

        The device runs preconditioned BiCGStab stages to the stage target
        (1e-6 in 32-bit arithmetic); between stages the exact residual,
        complex128 or float64 on the host, becomes the next right-hand
        side (the error equation), so stage reductions compound to the
        spec's true target.  ρ = overall contraction^(1/total iterations);
        the timed first stage extrapolates to the executed total."""
        report = self.last_outer_solve = {"probe": "skipped", "probe_iterations": 0, "stages": 0}
        try:
            spec = self.problem.outer_solver
            true_target = spec["target_reduction"]
            max_iterations = spec["max_iterations"]
            with profiling.span("evaluate.probe_state"):
                u0_host, f_host = self.problem.initial_state(
                    self.dtype, level=self._expression_level(expression),
                    rhs_seed=self.rhs_seed)
                f64 = tuple(np.asarray(x, self._np_acc) for x in f_host)
                res0_true = _host_norm(f64)
            if res0_true <= 0.0:
                return infinity, infinity, infinity

            # Short-horizon prescreen: a probe-capped outer solve, its
            # contraction rate projected to the true target.  A hopeless
            # preconditioner dies after `probe` iterations instead of the
            # full cap, with a projected count that keeps failures ordered.
            # Only for cycles the VM translates, as in the reference.
            probe_seed = None
            probe = spec.get("probe_iterations", 128)
            if (
                probe
                and self.init_seed is None
                and max_iterations > 4 * probe
                and self._vm_program(expression)[1] is not None
            ):
                (probe_solve, probe_operator), probe_omegas = self._build_outer_solver(
                    expression, probe_iterations=probe)
                p_x, p_res, p_res0, p_it = probe_solve(self._to_device(f64), probe_omegas)
                self._consecutive_device_failures = 0
                report.update(probe="killed", probe_iterations=p_it)
                if p_it == 0 or not math.isfinite(p_res) or p_res0 <= 0.0:
                    return infinity, infinity, infinity
                # p_res == 0.0 exactly is machine-zero convergence: the
                # best possible probe outcome, never a kill.
                if p_it >= probe and p_res > 0.0:
                    # Did not converge within the probe cap.
                    p_rate = (p_res / p_res0) ** (1.0 / p_it)
                    if p_rate >= 1.0:
                        return infinity, p_rate, max_iterations
                    projected = math.log(true_target) / math.log(p_rate)
                    # 2× slack: BiCGStab is non-monotone, a slow probe can
                    # still accelerate; only clearly infeasible runs die.
                    if projected > 2.0 * max_iterations:
                        return infinity, p_rate, int(min(projected, 10 * max_iterations))
                report["probe"] = "unused"
                if p_res < p_res0:
                    # The survivor's probe iterations are real work: they
                    # seed the staged solve.
                    report["probe"] = "survived"
                    probe_seed = (self._to_host(p_x, probe_operator.grid), probe_operator, p_it)

            (solve, outer_operator), omegas = self._build_outer_solver(expression)

            x_total = tuple(np.zeros(np.asarray(x).shape, self._np_acc) for x in u0_host)
            rhs_host = f64
            total_it = 0
            it1 = None
            rel = 1.0
            if probe_seed is not None:
                x_probe, probe_operator, p_it_seed = probe_seed
                with profiling.span("host_residual"):
                    r_probe = self._host_residual(probe_operator, x_probe, f64)
                    seeded_rel = _host_norm(r_probe) / res0_true
                if math.isfinite(seeded_rel) and seeded_rel < rel:
                    x_total, rhs_host, total_it, rel = x_probe, r_probe, p_it_seed, seeded_rel

            if self.init_seed is not None:
                # Seeded-initial-guess protocol: A·x = f from a random x0,
                # as the staged solve of the error equation A·e = f − A·x0
                # (the device stage guesses stay zero).
                rng0 = np.random.default_rng(int(self.init_seed))
                x_rand = tuple(
                    rng0.standard_normal(np.asarray(x).shape).astype(self._np_acc)
                    for x in u0_host
                )
                with profiling.span("host_residual"):
                    r0 = tuple(self._host_residual(outer_operator, x_rand, f64))
                    res0_init = _host_norm(r0)
                if res0_init > 0.0 and math.isfinite(res0_init):
                    x_total, rhs_host, res0_true, total_it, rel = x_rand, r0, res0_init, 0, 1.0

            for _stage in range(4):
                if rel <= true_target:
                    break
                x, res, res0s, it = solve(self._to_device(rhs_host), omegas)
                report["stages"] += 1
                self._consecutive_device_failures = 0
                if it == 0 or not math.isfinite(res) or res0s <= 0.0:
                    return infinity, infinity, infinity
                if it1 is None:
                    it1 = it
                    # The first stage's own contraction stays informative
                    # for diverged runs (res/res0 > 1 varies between
                    # individuals), unlike the host rel, which clamps at 1.
                    stage1_rho = (res / res0s) ** (1.0 / it) if res > 0.0 else infinity
                total_it += it
                with profiling.span("host_residual"):
                    x_total = tuple(
                        a + b for a, b in zip(x_total, self._to_host(x, outer_operator.grid)))
                    r_host = self._host_residual(outer_operator, x_total, f64)
                    new_rel = _host_norm(r_host) / res0_true
                if new_rel <= true_target:
                    rel = new_rel
                    break
                if total_it >= max_iterations or new_rel >= rel:
                    # Cap breach, or the restart no longer improves.
                    rel = min(rel, new_rel)
                    rho = max(rel ** (1.0 / total_it), stage1_rho)
                    return infinity, rho if math.isfinite(rho) else infinity, total_it
                rel = new_rel
                rhs_host = r_host
        except _DEVICE_ERRORS + _RANK_ERRORS:
            raise
        except (RuntimeError, ValueError, NotImplementedError, FloatingPointError):
            return infinity, infinity, infinity

        if rel > true_target:
            return infinity, rel ** (1.0 / max(total_it, 1)), total_it
        rho = rel ** (1.0 / total_it)
        if it1 is None:
            # The probe seed alone met the target and no staged solve ran;
            # the timed solve below runs to the same target itself.
            it1 = total_it
        # Timing: the median first stage, extrapolated to the executed
        # total (the cost per iteration does not depend on the stage).
        try:
            seconds = self._median_time(solve, (self._to_device(f64), omegas), evaluation_samples)
        except _DEVICE_ERRORS:
            self._device_failed()
            return infinity, rho, total_it
        return 1e3 * seconds * (total_it / max(it1, 1)), rho, total_it

    def generate_and_evaluate_group(
        self, expressions, infinity=1e100, evaluation_samples=3,
        global_variable_values=None,
    ):
        """Evaluation of same-structure individuals (counterpart of the
        reference's group path, evostencils_tpu/backend/evaluation.py:703).

        All expressions share the ω-parameterized structural key.  Their
        float32 power iterations run as one batched loop over a member axis
        (`BatchedPowerLoop`): a group of n is padded to its bucket
        (`group_bucket`) with the first member's ω, whose rates are dropped,
        and a group larger than the largest bucket is split there.  Every
        cycle of the batch runs each member's arithmetic (so a member's ρ
        is the one `generate_and_evaluate` gives it, bit for bit on the
        CPU), every red-black sweep that the kernel's gate takes is one
        batched launch, and on a card the batch runs on CUDA graphs: a VM
        program on its VM's interpreter for that bucket, a lowered
        structure on a StepCycle per (structure, bucket).  The time per
        iteration is measured once, on the first member that survives, by
        the single-member stage solve, and every later survivor shares it.
        Members go one by one in the reference's own cases (an outer
        solver, FAS, a 64-bit dtype, a member whose program differs, an
        error the reference catches); on a device mesh the power iterations
        run one member at a time.  Returns a list of
        (time_to_convergence_ms, ρ, iterations) triples.
        """
        t0 = time.perf_counter()
        try:
            return self._evaluate_group(expressions, infinity, evaluation_samples,
                                        global_variable_values)
        finally:
            self.group_s += time.perf_counter() - t0

    def _evaluate_group(self, expressions, infinity, evaluation_samples,
                        global_variable_values):
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

        # The 64-bit measurement has no power iteration to share.
        if (getattr(self.problem, "outer_solver", None) or self.uses_FAS()
                or dtype_is_64bit(self.dtype)):
            return one_by_one()
        try:
            (stage_solve, power_solve, _), omega_arg0 = self._build_solver(expressions[0])
            if isinstance(omega_arg0, Program):
                # Same-structure programs share opcodes; each member brings
                # its own ω.
                vm = self._vm_for(self._expression_level(expressions[0]))
                omega_args = []
                for e in expressions:
                    program = vm.translate(e)
                    if program is None or not np.array_equal(program.opcodes, omega_arg0.opcodes):
                        raise RuntimeError("no group path")
                    omega_args.append(program)
            else:
                omega_args = [self._omega_vector(e) for e in expressions]
            bucket = group_bucket(len(expressions))
            if len(expressions) > bucket:
                # As the reference: the halves drop global_variable_values.
                return self._evaluate_group(
                    expressions[:bucket], infinity, evaluation_samples, None
                ) + self._evaluate_group(
                    expressions[bucket:], infinity, evaluation_samples, None
                )
            u0, f, e0, zf = self._probe_state(expressions[0])
            if self.layout is not None:
                rates = [float(power_solve(e0, zf, w)[0]) for w in omega_args]
            else:
                rates = self._batched_rates(power_solve, e0, zf, omega_args, bucket)
                self.groups_batched += 1
                self.batched_members += len(expressions)
            self._consecutive_device_failures = 0
            self.groups += 1
            self.group_members += len(expressions)
        except _RANK_ERRORS:
            raise
        except _DEVICE_ERRORS:
            # A device fault poisons the members, as it poisons a single
            # evaluation; it never sends them one by one.
            self._device_failed()
            return [(infinity, infinity, infinity) for _ in expressions]
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

    @staticmethod
    def _batched_rates(power_solve, e0, zf, omega_args, bucket: int) -> list:
        """The members' power-iteration rates from one batched loop of
        `bucket` members: the probe's error and zero right-hand side for
        every member, the rows past the group's carrying its first member's
        ω; those rows' rates are dropped."""
        padded = list(omega_args) + [omega_args[0]] * (bucket - len(omega_args))
        if isinstance(padded[0], Program):
            omega_arg = batched_program(padded)
        else:
            omega_arg = np.stack(padded)
        e0 = tuple(x.expand((bucket,) + tuple(x.shape)).contiguous() for x in e0)
        zf = tuple(x.new_zeros((bucket,) + tuple(x.shape)) for x in zf)
        rates, _ = power_solve.batched(e0, zf, omega_arg)
        return [float(rate) for rate in rates[:len(omega_args)]]

    def evaluate_objectives(self, expression, evaluation_samples=3, infinity=1e100):
        """(ρ, time_per_iteration_ms): the NSGA-II objective pair."""
        t, rho, iterations = self.generate_and_evaluate(
            expression, infinity=infinity, evaluation_samples=evaluation_samples
        )
        if not math.isfinite(t) or t >= infinity:
            return rho, infinity
        return rho, t / iterations

    def _host_residual(self, operator, u_fields, f_fields):
        """Exact residual f − A·u on the host, in float64 (complex128 for
        complex fields); a variable entry applies the generator's own
        float64 or complex128 planes, not the lowering's cast copies."""
        out = []
        for i, row in enumerate(operator.entries):
            acc = np.array(
                f_fields[i],
                dtype=np.complex128 if np.iscomplexobj(f_fields[i]) else np.float64)
            for entry, u in zip(row, u_fields):
                if isinstance(entry, base.ZeroOperator):
                    continue
                gen = getattr(entry, "stencil_generator", None)
                if gen is not None and getattr(gen, "is_nonlinear", False):
                    raise NotImplementedError("host residual: nonlinear")
                if gen is not None and getattr(gen, "is_variable", lambda: False)():
                    offsets, planes = gen.generate_coefficient_arrays(entry.grid)
                    acc -= sops.numpy_apply_variable_stencil(
                        np.asarray(u, acc.dtype), offsets, planes)
                    continue
                stencil = entry.generate_stencil()
                if isinstance(stencil, periodic.PeriodicStencil):
                    if not stencil.is_uniform():
                        # As the reference: no exact residual, the
                        # measurement ends after this stage.
                        raise NotImplementedError("host residual: periodic entry")
                    stencil = stencil.as_constant()
                acc -= sops.numpy_apply_constant_stencil(np.asarray(u, acc.dtype), stencil)
            out.append(acc)
        return out
