"""Drive the PyTorch/CUDA port's fitness-evaluation paths once on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit.  It imports nothing of JAX and
fails loudly: without CUDA it exits non-zero before printing any result,
and any failed check makes it exit non-zero.  Phases, each printing one
JSON line:

1. device: the card, `nvidia-smi`'s name and power limit, and the time
   nvcc took to build the kernel library from csrc/.
2. kernel: the red-black sweep kernel against its plain torch version on
   the card, at every grid size the main path gives it (31² to 1023²) and a
   ragged 161×96, with a stencil for every instance of the kernel (the
   5-point and the 9-point stencil, a radius-1 stencil of another pattern,
   a radius-2 stencil and an asymmetric radius-4 one), ω = 1.15,
   max|Δ| < 5e-5; median CUDA-event times of
   the kernel and of the plain version at 511² and 1023², as device time
   (`ms`, calls queued back to back) and as the span of one call with the
   host's launch overhead (`call_ms`).
2b. kernel_batched: the kernel's batched launch (one launch for B members,
   each with its own ω: the group path's vmapped Pallas calls) at B = 1, 2,
   4, 8 and 16 and 63², 511² and 1023², with every stencil of the kernel
   phase: bit for bit equal to B single launches and within 5e-5 of its
   batched plain version; device times of both at 511² and 1023² beside B ×
   the single sweep's bound.
2c. stencil_kernel: the constant-stencil kernel (csrc/stencil2d.cu) in its
   three modes, apply (the 5-point operator), restrict (full weighting)
   and prolong (bilinear, injection included) at c = 2, at every level of
   the main path (63² to 1023²) in float32 and float64: bit for bit the
   plain torch chain it replaces, and the device time of both (and the
   span of one call) beside the bytes' bound over 3.35 TB/s and the
   launch floor.
3. levels: the kernel's device time on the 5-point stencil at every level
   of the main path (63² to 1023²), L2 warm as the main path finds it
   (evostencils_torch/measure.py, as for the kernel phase), beside the
   level's bound (12 bytes a point over 3.35 TB/s) and the
   share of that bound it reaches, and the launch floor: the device time
   of an empty kernel queued the same way.
4. main path: the 2D Poisson bench problem (levels 5-9, 511² finest, f32),
   16 seeded depth-4 grammar trees and the stored tuned champion, then the
   champion in the 1023² configuration of scripts/headline_1024.py (levels
   6-10), through TorchProgramGenerator.generate_and_evaluate on the card,
   with the kernel's launch counts by grid size; then the 511² champion
   again on the CPU through the same port, which must agree (ρ within 2 %,
   iterations within ±1).
4b. group: generate_and_evaluate_group on ω variants of the bench champion
   (seeded, ×0.85-1.1 of its stored ω) in groups of 2, 5, 16 and 20 at 511²
   (buckets 2, 8, 16 and 16 + 4), of the 3D champion in a float32 group of
   4 at 127³ (levels 3-7) and of the champion in a group of 2 at 1023²
   (levels 6-10), the kernel's launch counts set to 0 before and read after:
   every group ran batched, batched launches at (2|4|8|16, 511, 511) and (2,
   1023, 1023); each member against its serial generate_and_evaluate, ρ
   within 1e-5 relative and iterations equal (±1 only where ρ within that
   band rounds to another count), the bit-for-bit members counted; one
   shared time per iteration in each bucket's part of a group.  Printed: the
   power iteration's CUDA-event ms per member batched and serial, and the
   captures and bytes per bucket.
5. evolve: the evolution entry point, scripts/torch_optimize.py, in this
   process on the card: 2D Poisson levels 5-9 (511²) in f32, NSGA-II,
   μ = λ = 8, initial factor 2 and one generation (cut from 4 and 2 to
   fit the time limit), 3 evaluation samples, a
   fixed seed and --tune, its artifacts under chiprun_out/evolve/.  It
   reports the evaluations (and how many went through same-structure
   groups), the wall time and evaluations per hour, the VM hit rate, the
   best ρ and its iterations, the tuner's ρ before and after, and the
   kernel's launches by grid size during the run.  Checks: a finite
   fitness and best ρ < 1; the best-ρ individual re-evaluated gives its
   recorded ρ within 2 %; `generate_and_evaluate_group` on the champion
   with 4 ω variants agrees with each member's own evaluation (ρ within
   2 %, iterations within ±1) with one shared time per iteration; the
   kernel launched.
6. profile: one more evaluation of the 511² champion under
   torch.profiler, device events only: wall time, device busy time and idle
   share, device operations, the kernel's share; the full table by kernel
   goes to chiprun_out/profile_champion_eval.txt.
7. helmholtz: the published Helmholtz protocol on the card: levels 3-7
   (127² finest), complex128, outer target 1e-7.  (a) The textbook V(2,1)
   ω = 0.6 cycle as the preconditioner of BiCGStab, rung by rung at k = 80,
   160, 320 (the loop of scripts/torch_evaluate_helmholtz_ladder.py), then
   once more through `generate_and_evaluate(global_variable_values={"k":
   80.0})`, which takes the k-ladder and must return the mean of the rungs,
   or the sums up to a failing rung.  The ladder's outer cap is cut from the
   protocol's 10,000 to 600: an outer iteration takes tens of milliseconds
   of host time, and the rungs above k = 80 run into the full cap (that
   takes minutes each; scripts/torch_evaluate_helmholtz_ladder.py runs it).
   The k = 80 rung converges below the cut cap, so its count is the
   protocol's.  (b) The stored k = 320 champion
   (artifacts/helmholtz_k320_r5/individual_0.txt), its cap cut from
   10,000 to 2,000, through the optimizer's grammar-string entry: its
   count is recorded, not judged, because thousands of BiCGStab
   iterations follow the rounding (the reference measured 6,515 on its
   CPU, the port's CPU test 7,545; the card ran into the full cap); it
   must contract (ρ < 1) without a NaN.  The k = 80 rung must converge and is
   repeated on the CPU: the same verdict, the count within 20 %.  Per rung
   it prints iterations, ρ, time to target, ms per outer iteration, the
   probe's verdict and the stages.  A complex state never reaches the
   float32 kernel: zero launches.
8. helmholtz_c64: the same V(2,1) at k = 80 in complex64, the staged path
   that restarts from the complex128 host residual, its cap cut to 500.
   How far it gets, in how many stages and iterations, is recorded, not
   judged (the full cap: scripts/torch_evaluate_helmholtz_ladder.py --dtype
   complex64).
9. krylov_cgs: a V(2,2) cycle with red-black smoothing over the bench levels
   5-9 in float32 whose dense coarsest solve (31²) is replaced by a
   CoarseGridSolver with 80 iterations of conjugate gradients (twice the 40
   that tests/test_optimizer.py uses at 15²: CG's count grows with 1/h).
   ρ must be finite and within 0.05 of the same cycle's with the dense
   solve, and the kernel must have launched at 511².
10. helmholtz_evolve: scripts/torch_optimize.py on Helmholtz (k0 = 20,
   levels 3-5, complex128, SOGP, μ = λ = 4, initial factor 2, one
   generation, one ladder rung, outer cap 60, one evaluation sample),
   artifacts under
   chiprun_out/helmholtz_evolve/.  The best
   individual must have a finite fitness and re-evaluate to the iteration
   count it had during the run.

The problem families without a kernel (the sweep kernel's gate refuses
variable, 3D, two-field, nonlinear and complex operators, as the
reference's Pallas gate does), each at its published size, each phase
printing its wall seconds, its ms per iteration, the kernel's launches
(which must be 0) and the reference's n = 20 record beside its numbers:

11. varcoeff: variable-coefficient Poisson (κ = 10), levels 5-9 (511²),
   float32: the tuned champion with its stored ω, the same string untuned,
   the textbook V(2,1) and V(2,2) at ω = 0.8.  The tuned champion is
   repeated on the CPU (ρ within 2 %, iterations ±1) and must beat its
   untuned string.
12. poisson3d: the 3D champion untuned and with its stored ω at levels 2-6
   (63³) in float64 and at levels 3-7 (127³) in float32; the tuned 63³ run
   again on the CPU (2 % / ±1); every ρ finite and < 1.
13. elasticity: the tuned elasticity champion as a string untuned and with
   its ω at levels 5-8 (255², two fields) in float64, the tuned one on the
   CPU too (2 % / ±1); once more in float32, recorded and not judged.
14. fas: the FAS champion and both textbook V(2,2)s (Newton and Picard) at
   levels 5-9 (511²) in float32 through the optimizer's grammar-string
   entry (three timing samples for the champion, one for each textbook),
   each on CUDA graphs (the default: its stage loop captured per
   structure) and with cuda_graphs=False: ρ, iterations and each stage's
   executed count equal to the bit, a capture on graphs, ms per iteration
   both ways with the captures, their seconds and bytes printed; the
   champion's cycle alone (device ms from graph replays, wall ms eagerly)
   printed beside its ms per iteration inside the stage; the champion
   must beat both textbooks and agree with its CPU run (2 % / ±1); 20
   textbook Newton cycles through CycleLowering.lower on the card must
   reach the manufactured solution within 5e-3 in max norm.
15. helmholtz_robin: the textbook V(2,1) ω = 0.6 preconditioning BiCGStab
   with Robin boundaries, complex128, levels 3-7, k = 80, the outer cap cut
   to 600 like the ladder's; the count and ρ recorded, the CPU run with the
   same verdict and the count within 20 %.
16. fas_evolve: scripts/torch_optimize.py on FAS (levels 5-9, SOGP, μ = λ
   = 4, initial factor 2, one generation, one sample, seed 3), artifacts
   under chiprun_out/fas_evolve/; the best has a finite fitness and
   re-evaluates to its recorded count ±1; evaluations per hour, and the
   captures of the per-structure FAS graphs with their share of the
   evolution's wall time, printed.
17. profile_families: one evaluation (one timing sample) of the tuned
   variable-coefficient champion (511²) and one of the tuned 3D champion
   (127³, float32) under
   torch.profiler, and one cycle of each alone, and of the FAS champion
   (511²): wall and device busy time, idle share, device operations per
   cycle, the top operations by device time; the tables go to
   chiprun_out/profile_<family>_{eval,cycle}.txt.

The staged deep solves and the models:

18. headline: scripts/torch_headline_1024.py in this process at 1023²
   (levels 6-10), float32, --predicted --compare-eager, --repeats cut from
   9 to 3: textbook V(2,1), V(2,2) and
   artifacts/paper_protocol/individual_1_tuned.txt with its stored ω; then
   the V(2,2) through build_fused_staged_solver (no ρ), one solve and three
   timed.  Every solver runs on CUDA graphs (the default, captured once per
   solver) and with cuda_graphs=False: cycles, stages and rel (and the
   measured floor) equal to the bit, wall min and median per solve both
   ways, the device compute, the captures, their seconds and bytes.
   Checks: every solve reaches rel ≤ 1e-10 in host IEEE float64; the
   kernel launched at every smoothed level, 127²-511² (the TPU's
   whole-array route) and 1023² (its row-blocked route; 63² is the
   coarsest level, solved dense); a finite positive device time per cycle.
   Then a predicted V(2,2) at 255² on the card and on the CPU: cycles
   within ±2, stages within ±1.  The TPU's RESULTS.md R5.8 rows are
   printed beside, not judged.
19. models: the LFA ρ of the textbook V(2,2) two-grid cycle at 63² beside
   its measured ρ, and of the bench champion beside the main path's ρ
   (printed); scripts/torch_optimize.py --model-based (NSGA-II, μ = λ = 4,
   2 generations, levels 5-9), whose halls of fame must hold an individual
   with 0 < ρ < 1 and a positive runtime; the roofline's predicted device
   time per cycle of the calibration cases at 511² against per_cycle_time
   on the card, within 2×.

Problem files, the champion scripts and population dispatch:

20. problem_file: artifacts/problem_specs/2D_FD_Poisson_fromL2.exa2 through
   load_problem_file (levels 5-9 from its .knowledge file, 511², float32);
   the exafile champion of RESULTS.md R5.5 untuned and with its stored ω,
   one sample each, on the parsed problem and on poisson_2d(5, 9): ρ and
   iterations equal to the digit, the kernel's launches by grid size equal
   and > 0 at every level where the champion smooths red-black (127²-511²;
   at 63² it smooths with single-colour and block Jacobi), ρ < 1, no ∞; the
   TPU's R5.5 record printed beside.
   Then scripts/torch_optimize.py --problem-file (NSGA-II, μ = λ = 4, initial
   factor 2, one generation, one sample, seed 20260819; cut from R5.5's 16 × 20
   generations), artifacts under chiprun_out/problem_file/: a hall of fame
   holds 0 < ρ < 1.
21. problem_file_fas: the FAS champion on the FAS template
   (FAS_2D_Basic_template.exa4 at levels 5-9) and on fas_2d(5, 9), one
   timing sample each: both converge, ρ within 5 %, iterations ±1, no
   kernel launch.
22. scripts: torch_evaluate_reference_solver (V(2,1), 3 samples),
   torch_evaluate_evolved_solver (the exafile champion, 3 samples),
   torch_champion_stats (artifacts/paper_protocol/individual_0_tuned.txt,
   20 samples, untuned and tuned, JSON in chiprun_out/): median ρ within
   2 % and iterations ±1 of the JAX package's CPU record
   poisson2d_stats_n20_f32.json; torch_tune_champions (individual_0.txt,
   10 iterations, 1 sample, into chiprun_out/tuned/): the file parses back
   and its ω apply.  Levels 5-9, float32, each script launching the kernel.
23. dispatch: the first 8 of the 16 bench trees at 511² through the optimizer's evaluation
   path, one evaluation sample each, with SerialDispatcher and
   ThreadPoolDispatcher(2): ρ and iterations equal per tree, launches by
   grid size equal, evaluations per hour of both; then MultiHostDispatcher in two processes on this card (gloo over
   127.0.0.1), 6 ω variants of V(2,1): each process's gathered list equals
   its own serial evaluation, and both exit 0.

The device mesh (parallel/mesh.py):

24. mesh: scripts/torch_mesh_dryrun.py under torchrun, the 511² textbook
   V(2,2) (levels 5-9, float32) through TorchProgramGenerator(mesh=...):
   on one card as 2 gloo ranks (NCCL refuses two ranks on one GPU; gloo
   stages the halos through host buffers) and as 1 NCCL rank; on ≥ 2
   visible cards as one NCCL rank per card.  The first run's rank 0 also
   evaluates the same cycle unsharded on the card.  Checks, for every run:
   exit 0; ρ within 1e-5 relative of the unsharded run with
   `use_kernels=False` and equal iterations; within 2 % and ±1 of the
   unsharded default route; 0 kernel launches on every rank (the mesh
   path runs the plain ops by policy, as the reference's
   lowering.py:73-81).  Each run's backend, route, slab rows, transfer
   counts, ms to target and wall time are printed.  Then, on the same
   routes (2 gloo ranks and 1 NCCL rank on one card):
   (a) FAS, 511² float32 (levels 5-9), `replicate_below` 64: the stored
   champion and the textbook Newton V(2,2) through
   `scripts/torch_mesh_dryrun.py --problem fas`, the first run's rank 0
   evaluating both unsharded: the champion's ρ within 2 % and its count
   within ±1 of the unsharded run; the textbook's ρ comes from the stall
   rule and is printed, not judged.
   (b) Helmholtz, complex128, levels 3-7 (127²), k = 80, the textbook
   V(2,1) ω 0.6, the outer cap cut to 600 as the helmholtz phase's,
   `replicate_below` 16 (127² and 63² split): it converges, with the
   probe verdict and stages of the helmholtz phase's unsharded k = 80 rung
   and the count within 10 % of it; ms per outer iteration of each route.
   (c) scripts/torch_optimize.py --mesh 2,2 --multihost --seed 3 on 4 gloo
   ranks of this card (the rank bootstrap starts the gloo group): 2D
   Poisson at 511² (levels 5-9, `replicate_below` 64: 511², 255² and 127²
   split), NSGA-II, μ = λ = 4, initial factor 1, 1 generation, one sample:
   four identical logbooks and halls of fame, each dp row evaluated its
   half (the counts are printed), times reduced within a row, rank 0 alone
   wrote; three gathered individuals re-evaluated here unsharded with the
   plain ops: ρ within 1e-4 relative, iterations ±1.
   (d) scripts/torch_optimize.py --mesh 1,2 --seed 3 --tune on 2 gloo
   ranks, levels 3-6 (63², `replicate_below` 16: 63² split), μ = λ = 2,
   initial factor 1: both ranks publish the same ω, and rank 0 alone writes
   the tuned file when ρ did not grow, else the rejected one.  (c) and (d)
   start after PR 8's runs and run beside (a) and (b), whose times they
   slow.
   Every run launches the sweep kernel 0 times (`mesh_launches`).

CUDA graphs (backend/graphs.py).  Every phase's evaluations run their
measurement loops on CUDA graphs, the generator's default on a card (FAS
too; the mesh and the ω tuner stay eager by rule), the headline's staged
solves replay graphs captured once per solver, and every kernel launch
count includes the replays' launches.  A VM program
runs on its problem's interpreter: one graph per ISA branch, captured at
its first use, replayed in program order, with the loops' glue captured
once per problem; a lowered structure keeps graphs of its own.  The main
path checks that no capture failed, that the kernel's launches reached
the card through replays at every grid shape, that the VM path captured at
most one graph per registered branch and glue body (its captures, the
distinct structures and the branches registered printed for each
generator), and that a second pass of the 16 trees captures nothing and
holds no more bytes; it prints the bytes held and, for the champion's
program on its interpreter, the host's µs per graph replay beside the
device's ms per cycle.  The evolve phase prints the captures, their share
of the evolution's wall time, the bytes held and the same three VM numbers,
and judges the same bound.

25. graphs (run after the helmholtz phase): the main path's 16 trees and
   champion at 511² and its champion at 1023², the evolution (without
   --tune) and the Helmholtz k = 80 rung, again with `cuda_graphs=False`:
   ρ within 1e-6 relative (equal expected) with equal iterations, power
   cycles and stage lengths for every tree; the champion 0.05150734633207321
   in 10 on graphs; Helmholtz with the same probe verdict and stages and the
   count within 2 %.  Then, in a child process, the champion through a
   lowering whose operator reads one value to the host: a finite fitness
   eagerly, CudaGraphError on graphs and one failed capture; and a fused
   staged solver at 255² whose cycle reads one value to the host: it
   solves eagerly, and on graphs it raises CudaGraphError with one failed
   capture.  Printed, not
   judged: ms per iteration, evaluations per hour, ms per outer iteration,
   captures, replays, capture seconds, evictions and bytes held per mode.

Every phase's seconds are printed in a `seconds` record at the end, and
every record is also written to chiprun_out/chip_smoke_records.jsonl.

The kernels line lists the single launch in both roles (its launches on the
main path) and the batched launch in both roles (its launches in the group
phase, its times at 8 members).

Before the last line it prints the kernels as one JSON object and the card's
`nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from evostencils_torch.backend import graphs
from evostencils_torch.backend.device_solve import staged_solver_for_expression
from evostencils_torch.backend.evaluation import TorchProgramGenerator, group_bucket
from evostencils_torch.backend.vm import Program
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir import base, krylov, reference_cycles
from evostencils_torch.ir import partitioning as part
from evostencils_torch.ir.transformations import canonical_string, collect_cycles
from evostencils_torch.measure import HBM_BYTES_PER_MS, LEVELS, bound_ms, median_device_ms
from evostencils_torch.ops import _build, intergrid, rb_sweep, stencil_kernel
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.parallel.dispatch import SerialDispatcher, ThreadPoolDispatcher
from evostencils_torch.problems import elasticity, fas, load_problem_file, poisson
from evostencils_torch.problems.helmholtz import helmholtz_2d
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant, gallery
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file
from evostencils_torch.utils.timing import per_cycle_time, wall_cycle_time
from scripts import (
    torch_calibrate_roofline, torch_champion_stats, torch_evaluate_evolved_solver,
    torch_evaluate_helmholtz_ladder, torch_evaluate_reference_solver, torch_headline_1024,
    torch_optimize, torch_tune_champions,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
CHAMPION = os.path.join(ROOT, "artifacts", "poisson2d_champion_r2_tuned.txt")
HELMHOLTZ_CHAMPION = os.path.join(ROOT, "artifacts", "helmholtz_k320_r5", "individual_0.txt")
# Outer caps cut from the protocol's 10,000 to fit this script's time
# limit: one outer iteration of a V(2,1) preconditioner costs tens of
# milliseconds of host time.  The ladder's cap stays above 4 × the probe's
# 128 iterations, so the probe runs, and above the k = 80 rung's count.
LADDER_CAP = 600
C64_CAP = 500
# The k = 320 champion's cap, cut to fit the mesh runs: it runs into any
# cap on the card, and its count is recorded, not judged.
K320_CAP = 2000
KERNEL_SOURCE = "evostencils_torch/csrc/rb_sweep.cu"
TOLERANCE = 5e-5  # as tests/test_pallas.py holds the Pallas kernels
OMEGA = 1.15
STENCILS = {
    "5-point": constant.Stencil(
        (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0))
    ),
    "9-point": constant.Stencil(
        (((0, 0), 8.0 / 3), ((1, 0), -1 / 3), ((-1, 0), -1 / 3), ((0, 1), -1 / 3),
         ((0, -1), -1 / 3), ((1, 1), -1 / 3), ((1, -1), -1 / 3), ((-1, 1), -1 / 3),
         ((-1, -1), -1 / 3))
    ),
    # Radius 1, neither the 5-point nor the 9-point pattern.
    "skew": constant.Stencil((((0, 0), 2.0), ((1, 1), -0.5), ((-1, 0), -0.25), ((0, -1), -0.25))),
    "radius-2": constant.Stencil(
        (((0, 0), 2.5), ((2, -1), -0.5), ((-2, 1), 0.75), ((0, 2), -0.25), ((1, 0), -0.5))
    ),
    # No symmetry: a sign or axis error in the offsets shows up here.
    "asymmetric": constant.Stencil(
        (((0, 0), 4.0), ((1, 0), -1.5), ((-1, 0), -0.5), ((0, 1), -0.75), ((0, -2), -0.25),
         ((2, -1), 0.125), ((-4, 3), -0.0625), ((3, 4), 0.1))
    ),
}
# Every level of the main path (31²-511² in the bench configuration, 1023²
# in the headline one) and the ragged case of the row-blocked kernel's
# tests in tests/test_pallas.py.
CHECKED = [(31, 31), (63, 63), (127, 127), (255, 255), (511, 511), (1023, 1023), (161, 96)]
# The Pallas call each grid size went to on the TPU (whole-array up to
# 512² cells, row-blocked above: pallas_kernels.py:273), with its timed size.
ROLES = {
    "whole_array": ("evostencils_tpu/ops/pallas_kernels.py:238", (511, 511)),  # _rb_sweep_call
    "row_blocked": ("evostencils_tpu/ops/pallas_kernels.py:180", (1023, 1023)),  # _rb_blocked_call
}


def role(shape) -> str:
    """The Pallas call a launch of this key (rows, cols), or (members, rows,
    cols) for a batched launch, went to on the TPU."""
    return "whole_array" if shape[-2] * shape[-1] <= rb_sweep.WHOLE_ARRAY_CELLS else "row_blocked"


def batched(shape) -> bool:
    """Whether a launch count's key is a batched launch's."""
    return len(shape) == 3


def shape_label(shape) -> str:
    return "x".join(str(n) for n in shape)


START = time.perf_counter()
# Every record also goes here: the end of the output that a caller sees may
# not hold them all.
RECORDS_FILE = os.path.join(ROOT, "chiprun_out", "chip_smoke_records.jsonl")


def emit(record: dict) -> None:
    """One JSON line, also appended to RECORDS_FILE; `t_s` is the script's wall
    time when it was printed."""
    line = json.dumps({**record, "t_s": time.perf_counter() - START})
    print(line, flush=True)
    with open(RECORDS_FILE, "a") as records:
        records.write(line + "\n")


def median_call_ms(fn, repeats: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event span of one fn() call as the main path makes it:
    the host's launch overhead is inside the span."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    record = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_library": _build.library_path().name,
        "nvcc_s": _build.build_seconds,
        "build_and_load_s": time.perf_counter() - t0,
        "ptxas": [line.strip() for line in _build.build_log.splitlines() if "ptxas info" in line],
    }
    emit(record)
    return record


def phase_kernel(failures: list) -> dict:
    """Kernel vs plain version on the card; returns max|Δ| and times by size."""
    rng = np.random.default_rng(3)
    omega = torch.full((1,), OMEGA, dtype=torch.float32, device="cuda")
    by_shape = {}
    for shape in CHECKED:
        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        entry = {"shape": list(shape), "max_abs_err": {}}
        for name, stencil in STENCILS.items():
            out = rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil)
            ref = rb_sweep.rb_sweep_reference(u, f, omega, stencil)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            entry["max_abs_err"][name] = err
            if not err < TOLERANCE:
                failures.append(f"kernel {name} {shape}: max|Δ| {err} >= {TOLERANCE}")
        if shape in (timed for _, timed in ROLES.values()):
            stencil = STENCILS["5-point"]
            def kernel():
                return rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil)

            def plain():
                return rb_sweep.rb_sweep_reference(u, f, omega, stencil)

            entry["ms"] = median_device_ms(kernel)
            entry["plain_ms"] = median_device_ms(plain)
            entry["call_ms"] = median_call_ms(kernel)
            entry["plain_call_ms"] = median_call_ms(plain)
            entry["bound_ms"] = bound_ms(shape)
            entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
        by_shape[shape] = entry
        emit({"phase": "kernel", **entry})
    return by_shape


@contextlib.contextmanager
def plain_chain():
    """Every constant-stencil op as its plain torch chain: the gate refuses
    all (ops/stencil_kernel.py)."""
    kept = stencil_kernel.refusal
    stencil_kernel.refusal = lambda *args, **kwargs: "plain chain timed"
    try:
        yield
    finally:
        stencil_kernel.refusal = kept


def stencil_bound_ms(mode: str, shape, itemsize: int) -> float:
    """Least time of one constant-stencil op over the card's memory rate:
    apply reads the field and writes the output once; restrict reads the
    fine field and writes the coarse one; prolong reads the coarse field
    and writes the fine one."""
    fine = shape[0] * shape[1]
    coarse = ((shape[0] - 1) // 2) * ((shape[1] - 1) // 2)
    points = 2 * fine if mode == "apply" else fine + coarse
    return itemsize * points / HBM_BYTES_PER_MS


def phase_stencil_kernel(failures: list) -> list:
    """The constant-stencil kernel's three modes (the 5-point operator, a
    full-weighting restriction and a bilinear prolongation at c = 2) at
    every level of the main path in float32 and float64: bit for bit its
    plain chain, and the device time of both beside the bytes' bound."""
    rng = np.random.default_rng(6)
    five = STENCILS["5-point"]
    weighting = gallery.full_weighting_restriction_stencil(2)
    bilinear = gallery.multilinear_interpolation_stencil(2)
    floor_ms = median_device_ms(lambda: torch.cuda._sleep(0))
    entries = []
    for dtype in (torch.float32, torch.float64):
        itemsize = torch.finfo(dtype).bits // 8
        for shape in LEVELS:
            coarse_shape = tuple((n - 1) // 2 for n in shape)
            fine, coarse = (torch.from_numpy(rng.standard_normal(s)).to(dtype=dtype,
                                                                        device="cuda")
                            for s in (shape, coarse_shape))
            calls = {
                "apply": lambda: sops.apply_constant_stencil(fine, five),
                "restrict": lambda: intergrid.restrict(fine, weighting, coarse_shape, (2, 2)),
                "prolong": lambda: intergrid.prolong(coarse, bilinear, shape, (2, 2)),
            }
            for mode, call in calls.items():
                out = call()
                with plain_chain():
                    want = call()
                view = torch.int32 if dtype == torch.float32 else torch.int64
                same = bool(torch.equal(out.view(view), want.view(view)))
                if not same:
                    failures.append(f"stencil kernel {mode} {dtype} {shape}: not bit for bit "
                                    "the plain chain")
                entry = {"mode": mode, "dtype": str(dtype).replace("torch.", ""),
                         "shape": list(shape), "bitwise_equal_to_plain_chain": same,
                         "ms": median_device_ms(call),
                         "bound_ms": stencil_bound_ms(mode, shape, itemsize),
                         "launch_floor_ms": floor_ms}
                with plain_chain():
                    entry["plain_ms"] = median_device_ms(call)
                    entry["plain_call_ms"] = median_call_ms(call)
                entry["call_ms"] = median_call_ms(call)
                entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
                entries.append(entry)
                emit({"phase": "stencil_kernel", **entry})
    stencil_kernel.clear_counts()
    return entries


def phase_levels() -> list:
    """The kernel's device time at each level of the main path, with the
    5-point stencil, beside the level's bound and the launch floor."""
    emit({"phase": "levels", "launch_floor_ms": median_device_ms(lambda: torch.cuda._sleep(0))})
    rng = np.random.default_rng(4)
    omega = torch.full((1,), OMEGA, dtype=torch.float32, device="cuda")
    stencil = STENCILS["5-point"]
    levels = []
    for shape in LEVELS:
        u, f = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
                for _ in range(2))
        ms = median_device_ms(
            lambda: rb_sweep.red_black_collective_jacobi_sweep(u, f, omega, stencil))
        level = {"shape": list(shape), "ms": ms, "bound_ms": bound_ms(shape),
                 "share_of_bound": bound_ms(shape) / ms}
        levels.append(level)
        emit({"phase": "levels", **level})
    return levels


def bench_pset(problem):
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=4, maximum_local_system_size=8,
    )
    return pset


def load_champion(pset):
    tree_string, omegas = parse_champion_file(CHAMPION)
    champion = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
    return champion, apply_stored_omegas(champion, omegas, label="chip_smoke champion")


def check_results(failures: list, label: str, results) -> None:
    """No NaN anywhere, and no ρ of ∞: the poison of a device fault or of
    a cycle that failed to build (a diverging cycle has a finite ρ ≥ 1)."""
    for index, (t, rho, iterations) in enumerate(results):
        if any(math.isnan(v) for v in (t, rho, iterations)):
            failures.append(f"{label} {index}: a NaN fitness value")
        if math.isinf(rho):
            failures.append(f"{label} {index}: ρ is ∞ (device fault or build error)")


def check_capture_bound(failures: list, label: str, stats_by_generator: dict) -> None:
    """The VM path captures at most one graph per registered branch and
    glue body, however many structures it evaluated."""
    for name, stats in stats_by_generator.items():
        if stats["vm_captures"] > stats["branches_registered"] + stats["glue_bodies"]:
            failures.append(f"{label} {name}: {stats['vm_captures']} VM captures for "
                            f"{stats['branches_registered']} branches and {stats['glue_bodies']} "
                            f"glue bodies ({stats['structures']} structures)")
        if not stats["vm_captures"]:
            failures.append(f"{label} {name}: the VM path captured nothing: {stats}")


def interpreter_replay_times(generator, expression, cycles: int = 20) -> dict:
    """The expression's program on its interpreter, every branch captured:
    the host's µs per graph replay (the enqueue of `cycles` cycles over
    their replays) and the device's ms per cycle (CUDA events around them;
    the host enqueues ahead, so a gap shows only where it falls behind)."""
    vm, program = generator._vm_program(expression)
    interpreter = generator._interpreter(vm)
    with interpreter.lock:
        interpreter.load(program)
        interpreter.run_cycle()
        torch.cuda.synchronize()
        replays = graphs.counters.replays
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(cycles):
            interpreter.run_cycle()
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        count = graphs.counters.replays - replays
    return {"program_length": program.length, "replays_per_cycle": count / cycles,
            "host_us_per_replay": host_s / count * 1e6,
            "host_ms_per_cycle": host_s / cycles * 1e3,
            "device_ms_per_cycle": start.elapsed_time(end) / cycles}


def phase_main_path(failures: list) -> tuple:
    problem = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
    pset = bench_pset(problem)
    generator = TorchProgramGenerator(
        problem, dtype=torch.float32, iteration_limit=500, device="cuda")
    rng = random.Random(20260816)
    individuals = [gp.gen_grow(pset, 2, 16, rng=rng) for _ in range(16)]
    warm = gp.gen_grow(pset, 2, 10, rng=rng)
    generator.generate_and_evaluate(gp.compile_tree(warm, pset)[0], evaluation_samples=1)
    torch.cuda.synchronize()

    champion, omegas_applied = load_champion(pset)
    # The headline configuration: the same champion on levels 6-10.
    headline = TorchProgramGenerator(
        poisson_2d(min_level=6, max_level=10, dtype=torch.float32),
        dtype=torch.float32, iteration_limit=500, device="cuda")
    champion_1023, omegas_applied_1023 = load_champion(bench_pset(headline.problem))

    expressions = [gp.compile_tree(individual, pset)[0] for individual in individuals]
    rb_sweep.clear_counts()
    graphs.counters.reset()
    start = time.perf_counter()
    results, solves = [], []
    for expr in expressions:
        results.append(generator.generate_and_evaluate(expr, evaluation_samples=3))
        solves.append(generator.last_cycle_solve)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    t0 = time.perf_counter()
    champ_t, champ_rho, champ_iters = generator.generate_and_evaluate(
        champion, evaluation_samples=3)
    torch.cuda.synchronize()
    champ_eval_s = time.perf_counter() - t0
    champ_solve = generator.last_cycle_solve
    t0 = time.perf_counter()
    result_1023 = headline.generate_and_evaluate(champion_1023, evaluation_samples=3)
    torch.cuda.synchronize()
    eval_1023_s = time.perf_counter() - t0
    by_shape = dict(rb_sweep.launches)
    replayed = dict(rb_sweep.replayed)
    graph_record = {**graphs.counters.as_dict(), "bytes_held": graphs.bytes_held(),
                    "entries": len(generator.graph_cache) + len(headline.graph_cache),
                    "interpreter_bytes": {
                        "511": sum(i.nbytes for i in generator._interpreters.values()),
                        "1023": sum(i.nbytes for i in headline._interpreters.values())},
                    "vm": {"511": generator.graph_stats(), "1023": headline.graph_stats()}}
    # A second pass over the 16 trees: every branch they use has its graph,
    # so it captures nothing and holds no more bytes.
    captures, held = graphs.counters.captures, graphs.bytes_held()
    for expr in expressions:
        generator.generate_and_evaluate(expr, evaluation_samples=1)
    torch.cuda.synchronize()
    graph_record["second_pass"] = {"captures": graphs.counters.captures - captures,
                                   "bytes_held_before": held, "bytes_held_after": graphs.bytes_held()}
    graph_record["replay"] = interpreter_replay_times(generator, champion)
    launches_by_role = {name: 0 for name in ROLES}
    replayed_by_role = {name: 0 for name in ROLES}
    for shape, count in by_shape.items():
        launches_by_role[role(shape)] += count
        replayed_by_role[role(shape)] += replayed.get(shape, 0)

    record = {
        "phase": "main_path",
        "n_individuals": len(individuals),
        "elapsed_s": elapsed,
        "evals_per_hour": len(individuals) / elapsed * 3600.0,
        "converged": sum(1 for _, rho, _ in results if rho < 1.0),
        "best_rho": min(rho for _, rho, _ in results),
        "results": [list(r) for r in results],
        "vm_stats": generator.vm_stats(),
        "champion": {
            "rho": champ_rho, "iterations": champ_iters, "time_to_target_ms": champ_t,
            "eval_s": champ_eval_s, "omegas_applied": bool(omegas_applied),
        },
        "champion_1023": {
            "rho": result_1023[1], "iterations": result_1023[2],
            "time_to_target_ms": result_1023[0], "eval_s": eval_1023_s,
            "omegas_applied": bool(omegas_applied_1023),
        },
        "rb_sweep_launches": sum(by_shape.values()),
        "rb_sweep_launches_by_shape": launches_record(by_shape),
        "rb_sweep_replayed_by_shape": launches_record(replayed),
        "graphs": graph_record,
    }
    emit(record)

    check_results(failures, "tree", results)
    # The main path runs on CUDA graphs: every kernel launch of it at every
    # grid shape reached the card through replays too, and no capture failed.
    for shape in by_shape:
        if not replayed.get(shape):
            failures.append(f"main path: no replayed kernel launch at {shape[0]}x{shape[1]}")
    if graph_record["capture_failures"] or not graph_record["replays"]:
        failures.append(f"main path: graphs {graph_record}")
    check_capture_bound(failures, "main path", graph_record["vm"])
    second = graph_record["second_pass"]
    if second["captures"] or second["bytes_held_after"] != second["bytes_held_before"]:
        failures.append(f"main path: the second pass of the trees captured or held more: {second}")
    check_results(failures, "champion", [(champ_t, champ_rho, champ_iters), result_1023])
    for name, count in launches_by_role.items():
        if count == 0:
            failures.append(f"main path: the kernel never ran in its {name} role")
    if not champ_rho < 0.2:
        failures.append(f"main path: champion rho {champ_rho} >= 0.2")
    if not result_1023[1] < 1.0:
        failures.append(f"main path: champion at 1023² does not converge (rho {result_1023[1]})")
    if not (omegas_applied and omegas_applied_1023):
        failures.append("main path: the champion's stored omegas were not applied")

    cpu = TorchProgramGenerator(
        poisson_2d(min_level=5, max_level=9, dtype=torch.float32),
        dtype=torch.float32, iteration_limit=500, device="cpu")
    t0 = time.perf_counter()
    _, cpu_rho, cpu_iters = cpu.generate_and_evaluate(champion, evaluation_samples=1)
    emit({"phase": "champion_on_cpu", "rho": cpu_rho, "iterations": cpu_iters,
          "eval_s": time.perf_counter() - t0})
    if not abs(cpu_rho - champ_rho) <= 0.02 * champ_rho:
        failures.append(f"champion: CPU rho {cpu_rho} vs GPU {champ_rho} beyond 2 %")
    if not abs(cpu_iters - champ_iters) <= 1:
        failures.append(f"champion: CPU iterations {cpu_iters} vs GPU {champ_iters}")
    graph_mode = {
        "expressions": expressions, "results": results, "solves": solves,
        "evals_per_hour": record["evals_per_hour"],
        "champion": champion, "champion_result": (champ_t, champ_rho, champ_iters),
        "champion_solve": champ_solve, "champion_1023": champion_1023,
        "champion_1023_result": result_1023, "champion_1023_solve": headline.last_cycle_solve,
        "replayed_by_role": replayed_by_role,
    }
    return launches_by_role, generator, champion, champ_rho, graph_mode


EVOLVE_ARGS = [
    "--problem", "poisson2d", "--method", "nsga2", "--mu", "8", "--lambda", "8",
    "--generations", "1", "--min-level", "5", "--max-level", "9", "--dtype", "float32",
    "--population-initialization-factor", "2", "--evaluation-samples", "3", "--seed", "3",
    "--tune",
    "--output", os.path.join(ROOT, "chiprun_out", "evolve"),
]
# The same evolution on eager bodies, for the graphs phase (no tuning: the
# rate is the evolution's).
EVOLVE_EAGER_ARGS = [a for a in EVOLVE_ARGS[:-2] if a != "--tune"] + [
    "--output", os.path.join(ROOT, "chiprun_out", "evolve_eager")]
# The stored champion's ρ at 511², on the card and on the CPU alike.
CHAMPION_RHO = 0.05150734633207321


def omega_variants(compile_expression, stored, n: int) -> list:
    """compile_expression() with the stored ω and n - 1 seeded
    perturbations of them inside [0.1, 1.9]: one same-structure group."""
    rng = np.random.default_rng(13)
    members = []
    for i in range(n):
        expression = compile_expression()
        omegas = stored if i == 0 else np.clip(
            np.asarray(stored) * rng.uniform(0.85, 1.1, len(stored)), 0.1, 1.9)
        for cycle, omega in zip(collect_cycles(expression), omegas):
            cycle.relaxation_factor = float(omega)
        members.append(expression)
    return members


def champion_variants(pset, n: int) -> list:
    """The bench champion and n - 1 seeded ω variants of it."""
    return omega_variants(lambda: load_champion(pset)[0], parse_champion_file(CHAMPION)[1], n)


def phase_evolve(failures: list) -> dict:
    """Evolution through scripts/torch_optimize.py; returns the kernel's
    launches by grid shape during the run."""
    start = time.perf_counter()
    rb_sweep.launches.clear()
    graphs.counters.reset()
    result = torch_optimize.run(EVOLVE_ARGS)
    torch.cuda.synchronize()
    by_shape = dict(rb_sweep.launches)
    optimizer, generator = result.optimizer, result.generator
    evaluations = optimizer._total_number_of_evaluations
    graph_record = {**graphs.counters.as_dict(), "bytes_held": graphs.bytes_held(),
                    "entries": len(generator.graph_cache), "vm": generator.graph_stats()}
    # Warm-ups and captures of the run (the tuner's included) over the
    # evolution's wall time.
    graph_record["capture_share"] = graph_record["capture_s"] / result.evolution_s
    check_capture_bound(failures, "evolve", {"evolution": graph_record["vm"]})

    individuals = [ind for hof in result.halls_of_fame for ind in hof]
    converged = [ind for ind in individuals if ind.fitness_values[1] < optimizer.infinity]
    best = min(converged, key=lambda ind: ind.fitness_values[0]) if converged else None
    record = {
        "phase": "evolve",
        "args": " ".join(EVOLVE_ARGS[:-2]),
        "evaluations": evaluations,
        "group_members": generator.group_members,
        "groups": generator.groups,
        "evolution_s": result.evolution_s,
        "evals_per_hour": evaluations / result.evolution_s * 3600.0,
        "vm_stats": generator.vm_stats(),
        "converged_in_hall_of_fame": len(converged),
        "graphs": graph_record,
    }
    if graph_record["capture_failures"]:
        failures.append(f"evolve: graphs {graph_record}")
    if best is not None:
        expr = optimizer.compile_individual(best)[0]
        _, rho, iterations = generator.generate_and_evaluate(expr, evaluation_samples=3)
        record["best_rho"] = {"recorded": best.fitness_values[0], "reevaluated": rho,
                              "iterations": iterations}
        if not best.fitness_values[0] < 1.0:
            failures.append(f"evolve: best rho {best.fitness_values[0]} >= 1")
        if not abs(rho - best.fitness_values[0]) <= 0.02 * best.fitness_values[0]:
            failures.append(f"evolve: best-rho individual re-evaluated at {rho}, "
                            f"recorded {best.fitness_values[0]}")
    else:
        failures.append("evolve: no individual with a finite fitness")
    if result.tuning is not None:
        record["tuning"] = {"rho_before": result.tuning[0], "rho_after": result.tuning[1]}
    else:
        failures.append("evolve: --tune did not run")

    # The group path on the champion: 4 ω variants against their own
    # single evaluations, with one shared time per iteration.
    members = champion_variants(bench_pset(generator.problem), 4)
    group = generator.generate_and_evaluate_group(members, evaluation_samples=3)
    singles = [generator.generate_and_evaluate(e, evaluation_samples=3) for e in members]
    record["group_check"] = {"group": [list(r) for r in group],
                             "single": [list(r) for r in singles]}
    per_iteration = [t / it for t, _, it in group if math.isfinite(t) and t < optimizer.infinity]
    if len(per_iteration) != len(members) or max(per_iteration) - min(per_iteration) > (
            1e-9 * max(per_iteration)):
        failures.append(f"evolve: group times per iteration {per_iteration} are not one shared time")
    for (_, rho_g, it_g), (_, rho_s, it_s) in zip(group, singles):
        if not (abs(rho_g - rho_s) <= 0.02 * rho_s and abs(it_g - it_s) <= 1):
            failures.append(f"evolve: group member rho {rho_g} in {it_g} vs single "
                            f"{rho_s} in {it_s}")
    record["rb_sweep_launches"] = sum(by_shape.values())
    record["rb_sweep_launches_by_shape"] = launches_record(by_shape)
    if not by_shape:
        failures.append("evolve: the kernel never ran")
    record["phase_s"] = time.perf_counter() - start
    emit(record)
    return by_shape, record


# The batched launch: its member counts (one and the reference's buckets),
# the sizes it is checked at (the main path's coarsest smoothed level and
# the two roles' timed sizes), and the member count the kernels line quotes.
BATCHES = (1, 2, 4, 8, 16)
BATCHED_CHECKED = [(63, 63), (511, 511), (1023, 1023)]
BATCH_QUOTED = 8


def phase_kernel_batched(failures: list) -> dict:
    """The batched launch against B single launches (bit for bit) and its
    batched plain version (max|Δ| < TOLERANCE), with every stencil, at each
    B and size; device times of both at 511² and 1023² beside B × the
    single sweep's bound.  Returns the entries by (members, rows, cols)."""
    rng = np.random.default_rng(5)
    by_key = {}
    for shape in BATCHED_CHECKED:
        for members in BATCHES:
            u, f = (torch.from_numpy(rng.standard_normal((members,) + shape).astype(np.float32))
                    .cuda() for _ in range(2))
            omegas = torch.linspace(0.8, 1.3, members, device="cuda")
            entry = {"members": members, "shape": list(shape), "max_abs_err": {},
                     "bitwise_equal_to_single_launches": {}}
            for name, stencil in STENCILS.items():
                out = rb_sweep.red_black_collective_jacobi_sweep(u, f, omegas, stencil)
                singles = torch.stack([
                    rb_sweep.red_black_collective_jacobi_sweep(u[b], f[b], omegas[b], stencil)
                    for b in range(members)])
                ref = rb_sweep.rb_sweep_reference(u, f, omegas, stencil)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                same = bool(torch.equal(out, singles))
                entry["max_abs_err"][name] = err
                entry["bitwise_equal_to_single_launches"][name] = same
                if not err < TOLERANCE:
                    failures.append(f"batched kernel {name} {members}x{shape}: max|Δ| {err}")
                if not same:
                    failures.append(f"batched kernel {name} {members}x{shape}: not bit for bit "
                                    "its single launches")
            if shape in (timed for _, timed in ROLES.values()):
                stencil = STENCILS["5-point"]
                entry["ms"] = median_device_ms(
                    lambda: rb_sweep.red_black_collective_jacobi_sweep(u, f, omegas, stencil))
                entry["plain_ms"] = median_device_ms(
                    lambda: rb_sweep.rb_sweep_reference(u, f, omegas, stencil), calls=10)
                entry["bound_ms"] = members * bound_ms(shape)
                entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
            by_key[(members,) + shape] = entry
            emit({"phase": "kernel_batched", **entry})
    return by_key


# The group sizes of the group phase: buckets 2, 8 and 16, and 16 + 4.
GROUP_SIZES = (2, 5, 16, 20)


def _iterations_tie(rho: float, epsilon: float, band: float = 1e-5) -> bool:
    """Whether ρ moved by `band` relative rounds to another iteration count."""
    counts = {math.ceil(math.log(epsilon) / math.log(r))
              for r in (rho * (1 - band), rho, rho * (1 + band)) if 0.0 < r < 1.0}
    return len(counts) > 1


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def group_power_times(generator, members) -> dict:
    """CUDA-event span of the members' power iterations, warm: one batched
    loop of their bucket against one loop per member."""
    (_, power, _), first = generator._build_solver(members[0])
    if isinstance(first, Program):
        args = [generator._vm_program(e)[1] for e in members]
    else:
        args = [generator._omega_vector(e) for e in members]
    _, _, e0, zf = generator._probe_state(members[0])
    bucket = group_bucket(len(members))

    def batched_loop():
        generator._batched_rates(power, e0, zf, args, bucket)

    def serial_loops():
        for w in args:
            power(e0, zf, w)

    batched_loop()
    serial_loops()
    return {"members": len(members), "bucket": bucket,
            "batched_ms_per_member": _event_ms(batched_loop) / len(members),
            "serial_ms_per_member": _event_ms(serial_loops) / len(members)}


def check_group(failures: list, label: str, generator, members, group) -> dict:
    """The group's members against their own serial evaluations: ρ within
    1e-5 relative, iterations equal but where ρ sits within that band of a
    boundary (then ±1); one shared time per iteration in each bucket's
    part of the group."""
    singles = [generator.generate_and_evaluate(e, evaluation_samples=1) for e in members]
    bitwise = 0
    for index, ((_, rho, it), (_, rho_s, it_s)) in enumerate(zip(group, singles)):
        bitwise += (rho, it) == (rho_s, it_s)
        if math.isfinite(rho_s) and rho_s < 1e50:
            if not abs(rho - rho_s) <= 1e-5 * rho_s:
                failures.append(f"{label} member {index}: rho {rho} vs serial {rho_s}")
        elif rho != rho_s:
            failures.append(f"{label} member {index}: rho {rho} vs serial {rho_s}")
        if it != it_s and not (abs(it - it_s) <= 1 and _iterations_tie(rho_s, generator.epsilon)):
            failures.append(f"{label} member {index}: {it} iterations vs serial {it_s}")
    largest = rb_sweep.MAX_MEMBERS
    for part in range(0, len(group), largest):
        times = {t / it for t, _, it in group[part:part + largest] if t < 1e50}
        if len(times) > 1 and max(times) - min(times) > 1e-9 * max(times):
            failures.append(f"{label}: times per iteration {sorted(times)} are not one shared time")
    check_results(failures, label, group)
    return {"group": [list(r) for r in group], "serial": [list(r) for r in singles],
            "bitwise_equal_members": bitwise}


def phase_group(failures: list) -> dict:
    """The batched group path: ω variants of the bench champion at 511²
    (levels 5-9) in groups of 2, 5, 16 and 20, a 3D float32 group of 4
    variants of the 3D champion at 127³ (levels 3-7) and a group of 2 at
    1023² (levels 6-10, the row-blocked role), each through
    generate_and_evaluate_group on the card with the kernel's launch counts
    set to 0 just before and read just after; then each member against its
    serial evaluation, the power iterations timed batched and serial, and
    the graphs captured per bucket.  Returns the launches by key."""
    start = time.perf_counter()
    problem = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, iteration_limit=500,
                                      device="cuda")
    groups_2d = {n: champion_variants(bench_pset(problem), n) for n in GROUP_SIZES}
    problem_3d = poisson.poisson_3d(3, 7, dtype=torch.float32)
    generator_3d = TorchProgramGenerator(problem_3d, dtype=torch.float32, device="cuda")
    group_3d = omega_variants(
        lambda: artifact_expression(problem_3d, POISSON3D_CHAMPION, False, failures),
        parse_champion_file(POISSON3D_CHAMPION)[1], 4)
    problem_1023 = poisson_2d(min_level=6, max_level=10, dtype=torch.float32)
    generator_1023 = TorchProgramGenerator(problem_1023, dtype=torch.float32,
                                           iteration_limit=500, device="cuda")
    group_1023 = champion_variants(bench_pset(problem_1023), 2)

    rb_sweep.clear_counts()
    graphs.counters.reset()
    results, walls = {}, {}
    runs = [(f"511_n{n}", generator, members) for n, members in groups_2d.items()] + [
        ("127^3_n4", generator_3d, group_3d), ("1023_n2", generator_1023, group_1023)]
    for label, gen, members in runs:
        t0 = time.perf_counter()
        results[label] = gen.generate_and_evaluate_group(members, evaluation_samples=1)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
    by_shape = dict(rb_sweep.launches)
    counters = graphs.counters.as_dict()

    record = {"phase": "group", "wall_s": walls, "graphs": counters,
              "rb_sweep_launches_by_shape": launches_record(by_shape)}
    for label, gen, members in runs:
        record[label] = check_group(failures, f"group {label}", gen, members, results[label])
    record["power_ms"] = {label: group_power_times(gen, members) for label, gen, members in runs
                          if label in ("511_n5", "511_n16", "127^3_n4", "1023_n2")}
    record["buckets"] = {name: gen.graph_stats()["buckets"] for name, gen in (
        ("511", generator), ("127^3", generator_3d), ("1023", generator_1023))}
    record["counts"] = {name: {"groups": gen.groups, "groups_batched": gen.groups_batched,
                               "batched_members": gen.batched_members}
                        for name, gen in (("511", generator), ("127^3", generator_3d),
                                          ("1023", generator_1023))}
    record["phase_s"] = time.perf_counter() - start
    emit(record)

    for name, gen in (("511", generator), ("127^3", generator_3d), ("1023", generator_1023)):
        if not gen.groups_batched:
            failures.append(f"group {name}: no group ran batched")
    expected = {(2, 511, 511), (8, 511, 511), (16, 511, 511), (4, 511, 511), (2, 1023, 1023)}
    for key in sorted(expected - {k for k, n in by_shape.items() if n}):
        failures.append(f"group: no batched launch {shape_label(key)}")
    if counters["capture_failures"]:
        failures.append(f"group: graphs {counters}")
    return by_shape


def profile_run(evaluate, table_name: str, host_ops: bool = True) -> dict:
    """evaluate() once to warm, once timed, once under torch.profiler: wall
    time, device busy time, idle share and device operations; the profiler's
    table by kernel goes to chiprun_out/<table_name>.  The idle share is
    against the profiled run's own wall time, and the busy time is the union
    of the device intervals.  `host_ops=False` traces the
    device alone: a whole evaluation of a 127³ cycle records ~150,000
    device operations, and their host-side events take the profiler minutes
    to post-process."""
    from torch.profiler import ProfilerActivity, profile

    def synchronized():
        evaluate()
        torch.cuda.synchronize()

    synchronized()
    t0 = time.perf_counter()
    synchronized()
    wall_s = time.perf_counter() - t0
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        synchronized()
        profiled_wall_s = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, covered = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy_us += max(0.0, end - max(start, covered))
        covered = max(covered, end)
    busy_ms = busy_us / 1e3
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table_name), "w") as table:
        table.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda item: -item[1])[:6]
    return {
        "wall_ms": wall_s * 1e3, "profiled_wall_ms": profiled_wall_s * 1e3,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / (profiled_wall_s * 1e3),
        "device_ops": len(device),
        "top_device_ops": [{"name": name[:80], "ms": ms, "share": ms / busy_ms if busy_ms else None}
                           for name, ms in top],
        "events": device,
    }


def phase_profile(generator, champion) -> None:
    """One evaluation of the champion under torch.profiler (profile_run)."""
    run = profile_run(lambda: generator.generate_and_evaluate(champion, evaluation_samples=3),
                      "profile_champion_eval.txt", host_ops=False)
    sweep = [e for e in run.pop("events") if "rb_sweep_kernel" in e.name]
    emit({
        "phase": "profile", **run,
        "rb_sweep_kernel": {
            "launches": len(sweep),
            "busy_ms": sum(e.time_range.elapsed_us() for e in sweep) / 1e3,
        },
    })


def rung_record(rung) -> dict:
    """One evaluated rung of the k-ladder as a JSON record.  A converged
    rung's time per outer iteration is its timed solve's; a failed one's is
    its wall time (probe and stages) over the iterations it ran, which for
    a rung the probe killed are the probe's (its count is a projection)."""
    if rung.converged:
        ms_per_iteration = rung.time_ms / rung.iterations
    else:
        killed = rung.outer["probe"] == "killed"
        executed = rung.outer["probe_iterations"] if killed else rung.iterations
        ms_per_iteration = rung.wall_s * 1e3 / max(executed, 1)
    return {"k": rung.k, "converged": rung.converged, "iterations": rung.iterations,
            "rho": rung.rho, "time_to_target_ms": rung.time_ms if rung.converged else None,
            "ms_per_outer_iteration": ms_per_iteration, "wall_s": rung.wall_s, **rung.outer}


def textbook_v21(problem):
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=problem.max_level - problem.min_level,
        maximum_local_system_size=8,
    )
    return reference_cycles.generate_v_cycle(
        terminals, problem.rhs(), pre_smoothing=2, post_smoothing=1, omega=0.6)


# The k = 80 rung on the CPU, in a process of its own while the card runs
# the ladder (two threads: the card's host loop keeps its core); its record
# is the last line.
_CPU_K80 = """
import json
import torch
torch.set_num_threads(2)
import chip_smoke as cs
problem = cs.helmholtz_2d(min_level=3, max_level=7, k=80.0)
problem.outer_solver["max_iterations"] = cs.LADDER_CAP
generator = cs.TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
rung = cs.torch_evaluate_helmholtz_ladder.evaluate_ladder(
    generator, "textbook V(2,1) ω=0.6 on the CPU", cs.textbook_v21(problem), 80.0, 1)[0]
print(json.dumps(cs.rung_record(rung), default=float), flush=True)
"""


def phase_helmholtz(failures: list) -> dict:
    """The published protocol in complex128 on the card: the textbook
    V(2,1) across the k-ladder, the ladder call, the stored k = 320
    champion, and the k = 80 rung again on the CPU meanwhile.  Returns the
    k = 80 rung's record."""
    start = time.perf_counter()
    rb_sweep.launches.clear()
    cpu_proc = subprocess.Popen([sys.executable, "-c", _CPU_K80], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    try:
        return _helmholtz_on_card(failures, start, cpu_proc)
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.communicate()


def _helmholtz_on_card(failures: list, start: float, cpu_proc) -> dict:
    """phase_helmholtz's runs on the card; `cpu_proc` prints the CPU rung."""
    problem = helmholtz_2d(min_level=3, max_level=7, k=80.0)
    problem.outer_solver["max_iterations"] = LADDER_CAP
    cycle = textbook_v21(problem)
    generator = TorchProgramGenerator(problem, dtype=torch.complex128, device="cuda")
    rungs = torch_evaluate_helmholtz_ladder.evaluate_ladder(
        generator, "textbook V(2,1) ω=0.6", cycle, 80.0, 3)
    t0 = time.perf_counter()
    ladder = generator.generate_and_evaluate(
        cycle, evaluation_samples=1, global_variable_values={"k": 80.0})
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t0
    # The reference's rule: the mean over the rungs, or the sums up to and
    # with the first failing one.
    failing = next((i for i, r in enumerate(rungs) if not r.converged or r.rho > 1), None)
    counted = rungs if failing is None else rungs[:failing + 1]
    divisor = len(rungs) if failing is None else 1
    expected_iterations = sum(r.iterations for r in counted) / divisor
    expected_rho = sum(r.rho for r in counted) / divisor

    with open(HELMHOLTZ_CHAMPION) as f:
        champion = "".join(line for line in f if not line.startswith("#")).strip()
    problem_320 = helmholtz_2d(min_level=3, max_level=7, k=320.0, dtype=torch.complex128)
    problem_320.outer_solver["max_iterations"] = K320_CAP
    generator_320 = TorchProgramGenerator(problem_320, dtype=torch.complex128, device="cuda")
    optimizer = Optimizer.for_problem(
        problem_320, program_generator=generator_320, rng=random.Random(0))
    t0 = time.perf_counter()
    champ_t, champ_rho, champ_iterations = (
        optimizer.generate_and_evaluate_program_from_grammar_representation(
            champion, 4, evaluation_samples=1))
    torch.cuda.synchronize()
    champion_s = time.perf_counter() - t0

    out, err = cpu_proc.communicate()
    lines = [line for line in out.splitlines() if line.startswith("{")]
    cpu_rung = json.loads(lines[-1]) if cpu_proc.returncode == 0 and lines else None
    if cpu_rung is None:
        failures.append(f"helmholtz: the CPU rung exited {cpu_proc.returncode}: "
                        f"{(out + err)[-1500:]}")

    emit({
        "phase": "helmholtz", "dtype": "complex128", "levels": [3, 7], "target": 1e-7,
        "cap": problem.outer_solver["max_iterations"],
        "rungs": [rung_record(r) for r in rungs],
        "ladder_call": {"time_ms": ladder[0] if ladder[0] < 1e50 else None, "rho": ladder[1],
                        "iterations": ladder[2], "expected_iterations": expected_iterations,
                        "wall_s": ladder_s},
        "vm_stats": generator.vm_stats(),
        "champion_k320": {
            "iterations": champ_iterations, "rho": champ_rho,
            "time_to_target_ms": champ_t if champ_t < 1e50 else None,
            # Converged: the timed solve's; else the wall time over the run's iterations.
            "ms_per_outer_iteration": (champ_t if champ_t < 1e50 else champion_s * 1e3)
            / champ_iterations,
            "converged": champ_t < 1e50, "cap": problem_320.outer_solver["max_iterations"],
            "reference_iterations": 6515, "wall_s": champion_s,
            **generator_320.last_outer_solve,
        },
        "cpu_k80": cpu_rung,
        "rb_sweep_launches": rb_sweep.launches.total(),
        "phase_s": time.perf_counter() - start,
    })

    check_results(failures, "helmholtz rung", [(r.time_ms, r.rho, r.iterations) for r in rungs])
    check_results(failures, "helmholtz ladder and champion",
                  [ladder, (champ_t, champ_rho, champ_iterations)])
    if not (rungs[0].converged and rungs[0].rho < 1.0):
        failures.append(f"helmholtz: the k = 80 rung did not converge ({rungs[0]})")
    if ladder[2] != expected_iterations or abs(ladder[1] - expected_rho) > 1e-12:
        failures.append(f"helmholtz: the ladder call gave {ladder[1:]}, its rungs "
                        f"{(expected_rho, expected_iterations)}")
    if generator.problem.parameters["k"] != 80.0:
        failures.append("helmholtz: the ladder call did not restore k")
    if not (0.0 < champ_rho < 1.0 and champ_iterations >= 128):
        failures.append(f"helmholtz: the k = 320 champion does not contract "
                        f"(rho {champ_rho} in {champ_iterations} outer iterations)")
    if cpu_rung is not None and (cpu_rung["converged"] != rungs[0].converged or (
            abs(cpu_rung["iterations"] - rungs[0].iterations) > 0.2 * rungs[0].iterations)):
        failures.append(f"helmholtz: k = 80 on the CPU {cpu_rung} vs on the card {rungs[0]}")
    if rb_sweep.launches.total():
        failures.append("helmholtz: the float32 kernel launched on a complex state")
    return rung_record(rungs[0])


def phase_helmholtz_c64(failures: list) -> None:
    """V(2,1) at k = 80 in complex64: what the staged path does on the
    card is recorded; only a NaN fails."""
    problem = helmholtz_2d(min_level=3, max_level=7, k=80.0)
    problem.outer_solver["max_iterations"] = C64_CAP
    generator = TorchProgramGenerator(problem, dtype=torch.complex64, device="cuda")
    rung = torch_evaluate_helmholtz_ladder.evaluate_ladder(
        generator, "textbook V(2,1) ω=0.6 complex64", textbook_v21(problem), 80.0, 1)[0]
    emit({"phase": "helmholtz_c64", "dtype": "complex64", "cap": C64_CAP,
          "reached_1e-7": rung.converged,
          **rung_record(rung)})
    if any(math.isnan(v) for v in (rung.time_ms, rung.rho, rung.iterations)):
        failures.append(f"helmholtz_c64: a NaN fitness value ({rung})")


CG_ITERATIONS = 80


def v22_cycle(terminal_list, rhs, coarse_solver, level_index=0):
    """reference_cycles.generate_v_cycle's V(2,2) with red-black smoothing,
    its coarsest solve the CoarseGridSolver that `coarse_solver(A_c)` builds."""
    terminals = terminal_list[level_index]
    u, A = terminals.approximation, terminals.operator
    u = reference_cycles._smooth(u, rhs, A, 1.0, part.RedBlack, steps=2)
    f_c = base.Multiplication(terminals.restriction, base.Residual(A, u, rhs))
    if level_index + 1 < len(terminal_list):
        coarse = v22_cycle(terminal_list, f_c, coarse_solver, level_index + 1)
    else:
        coarse = base.Multiplication(coarse_solver(terminals.coarse_operator), f_c)
    u = base.Cycle(u, rhs, base.Multiplication(terminals.prolongation, coarse),
                   relaxation_factor=1.0)
    return reference_cycles._smooth(u, rhs, A, 1.0, part.RedBlack, steps=2)


def phase_krylov_cgs(failures: list) -> dict:
    """The float32 bench V(2,2) with a conjugate-gradient coarsest solve
    against the same cycle with the dense one; returns the kernel's launches
    by grid shape."""
    problem = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=problem.max_level - problem.min_level,
        maximum_local_system_size=8,
    )
    generator = TorchProgramGenerator(
        problem, dtype=torch.float32, iteration_limit=500, device="cuda")
    with_cg = v22_cycle(terminals, problem.rhs(), lambda A_c: base.CoarseGridSolver(
        "CGS", A_c, krylov.generate_conjugate_gradient(A_c, CG_ITERATIONS)))
    with_dense = v22_cycle(
        terminals, problem.rhs(), lambda A_c: base.CoarseGridSolver("CGS", A_c))
    rb_sweep.launches.clear()
    t0 = time.perf_counter()
    cg = generator.generate_and_evaluate(with_cg, evaluation_samples=3)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    by_shape = dict(rb_sweep.launches)
    dense = generator.generate_and_evaluate(with_dense, evaluation_samples=3)
    emit({
        "phase": "krylov_cgs", "cg_iterations": CG_ITERATIONS, "coarsest": [31, 31],
        "cg": {"time_to_target_ms": cg[0], "rho": cg[1], "iterations": cg[2], "eval_s": cg_s},
        "dense": {"time_to_target_ms": dense[0], "rho": dense[1], "iterations": dense[2]},
        "vm_stats": generator.vm_stats(),
        "rb_sweep_launches_by_shape": launches_record(by_shape),
    })
    check_results(failures, "krylov_cgs", [cg, dense])
    if not (math.isfinite(cg[1]) and abs(cg[1] - dense[1]) < 0.05):
        failures.append(f"krylov_cgs: rho {cg[1]} with CG vs {dense[1]} with the dense solve")
    if not by_shape.get((511, 511)):
        failures.append("krylov_cgs: the kernel never launched at 511²")
    return by_shape


HELMHOLTZ_EVOLVE_ARGS = [
    "--problem", "helmholtz", "--helmholtz-k0", "20", "--min-level", "3", "--max-level", "5",
    "--dtype", "complex128", "--method", "sogp", "--mu", "4", "--lambda", "4",
    "--generations", "1", "--ladder-rungs", "1", "--outer-cap", "60",
    "--population-initialization-factor", "2", "--evaluation-samples", "1", "--seed", "3",
    "--output", os.path.join(ROOT, "chiprun_out", "helmholtz_evolve"),
]


def phase_helmholtz_evolve(failures: list) -> None:
    """One generation of Helmholtz evolution through the entry point, every
    measurement kept by its cycle's canonical string, and the best
    individual evaluated once more."""
    measured = {}
    evaluate = TorchProgramGenerator.generate_and_evaluate

    def recording(self, expression, *args, **kwargs):
        result = evaluate(self, expression, *args, **kwargs)
        measured[canonical_string(expression)] = result
        return result

    start = time.perf_counter()
    TorchProgramGenerator.generate_and_evaluate = recording
    try:
        result = torch_optimize.run(HELMHOLTZ_EVOLVE_ARGS)
    finally:
        TorchProgramGenerator.generate_and_evaluate = evaluate
    optimizer, generator = result.optimizer, result.generator
    best = result.halls_of_fame[-1][0]
    expr = optimizer.compile_individual(best)[0]
    during = measured.get(canonical_string(expr))
    again = generator.generate_and_evaluate(
        expr, evaluation_samples=3, global_variable_values={"k": 20.0})
    emit({
        "phase": "helmholtz_evolve", "args": " ".join(HELMHOLTZ_EVOLVE_ARGS[:-2]),
        "evaluations": optimizer._total_number_of_evaluations,
        "evolution_s": result.evolution_s, "vm_stats": generator.vm_stats(),
        "best": {"fitness": list(best.fitness_values),
                 "during": list(during) if during else None, "reevaluated": list(again)},
        "phase_s": time.perf_counter() - start,
    })
    check_results(failures, "helmholtz_evolve", [again])
    if not (math.isfinite(best.fitness_values[0]) and best.fitness_values[0] < 1e50):
        failures.append(f"helmholtz_evolve: best fitness {best.fitness_values}")
    if during is None or during[2] != again[2] or not again[0] < 1e50:
        failures.append(f"helmholtz_evolve: the best individual had {during} during the run "
                        f"and {again} evaluated again")


# ---------------------------------------------------------------------------
# The problem families without a kernel.
# ---------------------------------------------------------------------------

# The family phases' device; their CPU repeats name the CPU themselves.
DEVICE = "cuda"
ARTIFACTS = os.path.join(ROOT, "artifacts")
VARCOEFF_CHAMPION = os.path.join(ARTIFACTS, "varcoeff_champion_r5_tuned.txt")
VARCOEFF_TEXTBOOKS = {name: os.path.join(ARTIFACTS, f"varcoeff_textbook_{name}_w0.8.txt")
                      for name in ("V21", "V22")}
POISSON3D_CHAMPION = os.path.join(ARTIFACTS, "secondary_r3", "poisson3d_individual_0_tuned.txt")
ELASTICITY_CHAMPION = os.path.join(ARTIFACTS, "secondary_r3", "elasticity_individual_0_tuned.txt")
FAS_CHAMPION = os.path.join(ARTIFACTS, "fas_champion_r5.txt")
FAS_TEXTBOOKS = {name: os.path.join(ARTIFACTS, f"fas_textbook_V22_jacobi_{name}.txt")
                 for name in ("newton", "picard")}
# The reference's n = 20 statistics (JAX on a CPU, scripts/champion_stats.py,
# one seeded random right-hand side per sample): cross-checks, not targets.
RECORDS = {
    "varcoeff": os.path.join(ARTIFACTS, "varcoeff_stats_n20_r5.json"),
    "poisson3d_63": os.path.join(ARTIFACTS, "secondary_r3", "poisson3d_stats_n20_64cubed_r5.json"),
    "poisson3d_127": os.path.join(
        ARTIFACTS, "secondary_r3", "poisson3d_stats_n20_128cubed_generalization.json"),
    "elasticity_f64": os.path.join(ARTIFACTS, "secondary_r3", "elasticity_stats_n20_f64.json"),
    "elasticity_f32": os.path.join(ARTIFACTS, "secondary_r3", "elasticity_stats_n20.json"),
    "fas": os.path.join(ARTIFACTS, "fas_stats_n20_r5.json"),
}


def reference_record(key: str, path: str, label: str = "untuned"):
    """The median ρ and iterations the reference's n = 20 record gives the
    champion file `path` (`label`: "untuned" or "tuned"), or None."""
    with open(RECORDS[key]) as f:
        report = json.load(f)
    for champion in report["champions"]:
        if os.path.basename(champion["file"]) == os.path.basename(path) and label in champion:
            entry = champion[label]
            return {"rho": entry["rho"]["median"], "iterations": entry["iterations"]["median"],
                    "n": entry["rho"]["n"], "levels": report["levels"]}
    return None


def family_pset(problem):
    pset, _ = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=problem.max_level - problem.min_level,
        maximum_local_system_size=8, FAS=bool(problem.uses_fas),
    )
    return pset


def artifact_expression(problem, path: str, tuned: bool, failures: list):
    """A stored grammar string compiled through the problem's primitive set,
    with its stored ω when `tuned`."""
    tree_string, omegas = parse_champion_file(path)
    pset = family_pset(problem)
    expr = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
    if tuned and not apply_stored_omegas(expr, omegas, label=path):
        failures.append(f"{os.path.basename(path)}: its stored omegas were not applied")
    return expr


def fitness_record(fitness, started: float) -> dict:
    """A (time to target, ρ, iterations) fitness as a JSON record, with ms
    per iteration (time to target over the count) and the wall seconds
    since `started`."""
    t, rho, iterations = fitness
    converged = t < 1e50
    return {"rho": rho, "iterations": iterations,
            "time_to_target_ms": t if converged else None,
            "ms_per_iteration": t / iterations if converged else None,
            "wall_s": time.perf_counter() - started}


def timed_evaluation(generator, expr, samples: int = 3) -> dict:
    t0 = time.perf_counter()
    fitness = generator.generate_and_evaluate(expr, evaluation_samples=samples)
    if generator.device.type == "cuda":
        torch.cuda.synchronize()
    return fitness_record(fitness, t0)


def check_cpu_repeat(failures: list, label: str, card: dict, cpu: dict) -> None:
    if not abs(cpu["rho"] - card["rho"]) <= 0.02 * card["rho"]:
        failures.append(f"{label}: CPU rho {cpu['rho']} vs card {card['rho']} beyond 2 %")
    if not abs(cpu["iterations"] - card["iterations"]) <= 1:
        failures.append(f"{label}: CPU iterations {cpu['iterations']} vs card {card['iterations']}")


def check_contracts(failures: list, label: str, result: dict) -> None:
    if not (math.isfinite(result["rho"]) and 0.0 < result["rho"] < 1.0):
        failures.append(f"{label}: rho {result['rho']} is not a finite contraction")


def check_no_launch(failures: list, phase: str) -> int:
    """The sweep kernel's launches since the phase began: the gate must
    refuse these operators, so any launch is a failure."""
    launched = rb_sweep.launches.total()
    if launched:
        failures.append(f"{phase}: the sweep kernel launched {launched} times on an operator "
                        "its gate must refuse")
    return launched


def phase_varcoeff(failures: list) -> int:
    start = time.perf_counter()
    rb_sweep.launches.clear()
    problem = poisson.poisson_2d_variable(5, 9, kappa=10.0, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=DEVICE)
    runs = {
        "tuned": (VARCOEFF_CHAMPION, True, "tuned"),
        "untuned": (VARCOEFF_CHAMPION, False, "untuned"),
        "textbook_V21": (VARCOEFF_TEXTBOOKS["V21"], False, "untuned"),
        "textbook_V22": (VARCOEFF_TEXTBOOKS["V22"], False, "untuned"),
    }
    results = {}
    for name, (path, tuned, label) in runs.items():
        results[name] = timed_evaluation(
            generator, artifact_expression(problem, path, tuned, failures))
        results[name]["reference_n20"] = reference_record("varcoeff", path, label)
    launched = check_no_launch(failures, "varcoeff")
    cpu = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    results["tuned_on_cpu"] = timed_evaluation(
        cpu, artifact_expression(problem, VARCOEFF_CHAMPION, True, failures), samples=1)
    emit({"phase": "varcoeff", "levels": [5, 9], "dtype": "float32", "kappa": 10.0,
          **results, "vm_stats": generator.vm_stats(), "rb_sweep_launches": launched,
          "phase_s": time.perf_counter() - start})
    for name, result in results.items():
        check_contracts(failures, f"varcoeff {name}", result)
    check_cpu_repeat(failures, "varcoeff tuned", results["tuned"], results["tuned_on_cpu"])
    if not results["tuned"]["rho"] < results["untuned"]["rho"]:
        failures.append(f"varcoeff: tuned rho {results['tuned']['rho']} does not beat "
                        f"untuned {results['untuned']['rho']}")
    return launched


def phase_poisson3d(failures: list) -> int:
    start = time.perf_counter()
    rb_sweep.launches.clear()
    configurations = {
        "63": (poisson.poisson_3d(2, 6, dtype=torch.float64), torch.float64, "poisson3d_63"),
        "127": (poisson.poisson_3d(3, 7, dtype=torch.float32), torch.float32, "poisson3d_127"),
    }
    results = {}
    for size, (problem, dtype, record) in configurations.items():
        generator = TorchProgramGenerator(problem, dtype=dtype, device=DEVICE)
        for label in ("untuned", "tuned"):
            result = timed_evaluation(generator, artifact_expression(
                problem, POISSON3D_CHAMPION, label == "tuned", failures))
            result["reference_n20"] = reference_record(record, POISSON3D_CHAMPION, label)
            results[f"{label}_{size}^3_{str(dtype).split('.')[-1]}"] = result
    launched = check_no_launch(failures, "poisson3d")
    problem, dtype, _ = configurations["63"]
    cpu = TorchProgramGenerator(problem, dtype=dtype, device="cpu")
    results["tuned_63^3_float64_on_cpu"] = timed_evaluation(
        cpu, artifact_expression(problem, POISSON3D_CHAMPION, True, failures), samples=1)
    emit({"phase": "poisson3d", **results, "rb_sweep_launches": launched,
          "phase_s": time.perf_counter() - start})
    for name, result in results.items():
        check_contracts(failures, f"poisson3d {name}", result)
    check_cpu_repeat(failures, "poisson3d tuned 63³", results["tuned_63^3_float64"],
                     results["tuned_63^3_float64_on_cpu"])
    return launched


def phase_elasticity(failures: list) -> int:
    start = time.perf_counter()
    rb_sweep.launches.clear()
    problem = elasticity.linear_elasticity_2d(5, 8, dtype=torch.float64)
    generator = TorchProgramGenerator(problem, dtype=torch.float64, device=DEVICE)
    results = {}
    for label in ("untuned", "tuned"):
        results[label] = timed_evaluation(generator, artifact_expression(
            problem, ELASTICITY_CHAMPION, label == "tuned", failures))
        results[label]["reference_n20"] = reference_record(
            "elasticity_f64", ELASTICITY_CHAMPION, label)
    problem32 = problem._clone(dtype=torch.float32)
    results["tuned_float32_not_judged"] = timed_evaluation(
        TorchProgramGenerator(problem32, dtype=torch.float32, device=DEVICE),
        artifact_expression(problem32, ELASTICITY_CHAMPION, True, failures))
    results["tuned_float32_not_judged"]["reference_n20"] = reference_record(
        "elasticity_f32", ELASTICITY_CHAMPION, "tuned")
    launched = check_no_launch(failures, "elasticity")
    cpu = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    results["tuned_on_cpu"] = timed_evaluation(
        cpu, artifact_expression(problem, ELASTICITY_CHAMPION, True, failures), samples=1)
    emit({"phase": "elasticity", "levels": [5, 8], "dtype": "float64", "fields": 2, **results,
          "vm_stats": generator.vm_stats(), "rb_sweep_launches": launched,
          "phase_s": time.perf_counter() - start})
    for name in ("untuned", "tuned", "tuned_on_cpu"):
        check_contracts(failures, f"elasticity {name}", results[name])
    if math.isnan(results["tuned_float32_not_judged"]["rho"]):
        failures.append("elasticity: a NaN rho in float32")
    check_cpu_repeat(failures, "elasticity tuned", results["tuned"], results["tuned_on_cpu"])
    return launched


def grammar_entry_evaluation(problem, device, path: str, samples: int = 3,
                             cuda_graphs=None) -> dict:
    """A stored grammar string through the optimizer's grammar-string entry,
    which builds the primitive set (the FAS one for a FAS problem), with
    `samples` timing samples on the card (one on the CPU).  On the card it
    also records each stage's executed count and what the generator's
    graphs captured: their count, seconds and bytes."""
    with open(path) as f:
        tree_string = "".join(line for line in f if not line.startswith("#")).strip()
    generator = TorchProgramGenerator(problem, dtype=problem.dtype, device=device,
                                      cuda_graphs=cuda_graphs)
    optimizer = Optimizer.for_problem(problem, program_generator=generator, rng=random.Random(0))
    before = graphs.counters.as_dict()
    t0 = time.perf_counter()
    fitness = optimizer.generate_and_evaluate_program_from_grammar_representation(
        tree_string, 8, evaluation_samples=1 if device == "cpu" else samples)
    if device == "cpu":
        return fitness_record(fitness, t0)
    torch.cuda.synchronize()
    record = fitness_record(fitness, t0)
    after = graphs.counters.as_dict()
    cache = generator.graph_cache
    record.update(
        stage_executed=generator.last_cycle_solve["stage_executed"],
        captures=after["captures"] - before["captures"],
        capture_s=after["capture_s"] - before["capture_s"],
        graph_bytes=0 if cache is None else cache.bytes_held)
    return record


FAS_GRAPH_KEYS = ("rho", "iterations", "stage_executed")


def phase_fas(failures: list) -> int:
    """The FAS champion and both textbooks on CUDA graphs (the default) and
    with cuda_graphs=False: ρ, iterations and each stage's executed count
    equal to the bit, ms per iteration both ways; the champion's cycle
    alone on a graph and eagerly beside its ms per iteration in the stage;
    20 Newton cycles; the champion on the CPU."""
    start = time.perf_counter()
    rb_sweep.launches.clear()
    problem = fas.fas_2d(5, 9, dtype=torch.float32)
    results, eager = {}, {}
    for name, path, samples in (("champion", FAS_CHAMPION, 3),
                                *((f"textbook_{n}", p, 1) for n, p in FAS_TEXTBOOKS.items())):
        # One timing sample for a textbook: its ρ is the stall rule's, its
        # time is printed, and three samples took ~25 s each eagerly.
        results[name] = grammar_entry_evaluation(problem, DEVICE, path, samples=samples)
        results[name]["reference_n20"] = reference_record("fas", path)
        eager[name] = grammar_entry_evaluation(problem, DEVICE, path, samples=samples,
                                               cuda_graphs=False)
    graph_vs_eager = {
        name: {"equal": all(results[name][k] == eager[name][k] for k in FAS_GRAPH_KEYS),
               **{k: {"graphs": results[name][k], "eager": eager[name][k]}
                  for k in FAS_GRAPH_KEYS + ("ms_per_iteration", "wall_s")},
               "captures": results[name]["captures"], "capture_s": results[name]["capture_s"],
               "graph_bytes": results[name]["graph_bytes"]}
        for name in results}

    # The champion's cycle alone: device ms per cycle from graph replays
    # (utils/timing.per_cycle_time) and the wall ms of an eager cycle,
    # beside its ms per iteration inside the stage solve.
    champion = artifact_expression(problem, FAS_CHAMPION, False, failures)
    step = CycleLowering(torch.float32, DEVICE).lower(champion)
    u0, f0 = problem.initial_state(torch.float32, device=DEVICE)
    cycle_alone = {
        "device_ms_graph_replays": 1e3 * per_cycle_time(step, u0, f0, iters=5, repeats=3),
        "wall_ms_eager": 1e3 * wall_cycle_time(step, u0, f0, iters=5, repeats=3),
        "in_stage_ms_per_iteration": {
            mode: r["champion"]["ms_per_iteration"] for mode, r in (("graphs", results),
                                                                     ("eager", eager))},
    }

    # Twenty textbook Newton cycles on the card from the zero guess.
    newton = artifact_expression(problem, FAS_TEXTBOOKS["newton"], False, failures)
    step = CycleLowering(torch.float32, DEVICE).lower(newton)
    u, f = problem.initial_state(torch.float32, device=DEVICE)
    t0 = time.perf_counter()
    for _ in range(20):
        u = step(u, f)
    torch.cuda.synchronize()
    cycles_s = time.perf_counter() - t0
    x, y = problem.interior_coordinates(problem.max_level)
    error = float(np.max(np.abs(u[0].double().cpu().numpy() - fas._solution(x, y))))
    launched = check_no_launch(failures, "fas")
    results["champion_on_cpu"] = grammar_entry_evaluation(problem, "cpu", FAS_CHAMPION)
    emit({"phase": "fas", "levels": [5, 9], "dtype": "float32", **results,
          "graphs_vs_eager": graph_vs_eager, "champion_cycle_alone": cycle_alone,
          "newton_20_cycles": {"max_error": error, "wall_s": cycles_s,
                               "ms_per_cycle": cycles_s * 1e3 / 20},
          "rb_sweep_launches": launched, "phase_s": time.perf_counter() - start})
    for name, result in results.items():
        check_contracts(failures, f"fas {name}", result)
    for name, pair in graph_vs_eager.items():
        if not pair["equal"]:
            failures.append(f"fas {name}: on graphs and eagerly {pair}")
        if not pair["captures"] > 0:
            failures.append(f"fas {name}: captured no graph on the card")
    for name in FAS_TEXTBOOKS:
        if not results["champion"]["rho"] < results[f"textbook_{name}"]["rho"]:
            failures.append(f"fas: champion rho {results['champion']['rho']} does not beat the "
                            f"textbook {name} V(2,2)'s {results[f'textbook_{name}']['rho']}")
    check_cpu_repeat(failures, "fas champion", results["champion"], results["champion_on_cpu"])
    if not error < 5e-3:
        failures.append(f"fas: 20 Newton cycles end {error} from the manufactured solution")
    return launched


def phase_helmholtz_robin(failures: list) -> int:
    start = time.perf_counter()
    rb_sweep.launches.clear()
    problem = helmholtz_2d(min_level=3, max_level=7, k=80.0, boundary="robin",
                           dtype=torch.complex128)
    problem.outer_solver["max_iterations"] = LADDER_CAP
    cycle = textbook_v21(problem)
    generator = TorchProgramGenerator(problem, dtype=torch.complex128, device=DEVICE)
    rung = torch_evaluate_helmholtz_ladder.evaluate_ladder(
        generator, "textbook V(2,1) ω=0.6 Robin", cycle, 80.0, 1)[0]
    launched = check_no_launch(failures, "helmholtz_robin")
    cpu = TorchProgramGenerator(problem, dtype=torch.complex128, device="cpu")
    cpu_rung = torch_evaluate_helmholtz_ladder.evaluate_ladder(
        cpu, "textbook V(2,1) ω=0.6 Robin on the CPU", cycle, 80.0, 1)[0]
    emit({"phase": "helmholtz_robin", "dtype": "complex128", "levels": [3, 7], "k": 80.0,
          "boundary": "robin", "cap": LADDER_CAP, "card": rung_record(rung),
          "cpu": rung_record(cpu_rung), "vm_stats": generator.vm_stats(),
          # The reference keeps no statistics of Robin boundaries.
          "reference_n20": None, "rb_sweep_launches": launched,
          "phase_s": time.perf_counter() - start})
    check_results(failures, "helmholtz_robin", [(rung.time_ms, rung.rho, rung.iterations)])
    if cpu_rung.converged != rung.converged or (
            abs(cpu_rung.iterations - rung.iterations) > 0.2 * rung.iterations):
        failures.append(f"helmholtz_robin: the CPU {cpu_rung} vs the card {rung}")
    return launched


FAS_EVOLVE_ARGS = [
    "--problem", "fas", "--method", "sogp", "--mu", "4", "--lambda", "4",
    "--population-initialization-factor", "2", "--generations", "1",
    "--evaluation-samples", "1", "--seed", "3",
    "--output", os.path.join(ROOT, "chiprun_out", "fas_evolve"),
]


def phase_fas_evolve(failures: list) -> int:
    """One generation of FAS evolution through the entry point; the best
    individual evaluated once more."""
    measured = {}
    evaluate = TorchProgramGenerator.generate_and_evaluate

    def recording(self, expression, *args, **kwargs):
        result = evaluate(self, expression, *args, **kwargs)
        measured[canonical_string(expression)] = result
        return result

    start = time.perf_counter()
    rb_sweep.launches.clear()
    before = graphs.counters.as_dict()
    TorchProgramGenerator.generate_and_evaluate = recording
    try:
        result = torch_optimize.run(FAS_EVOLVE_ARGS)
    finally:
        TorchProgramGenerator.generate_and_evaluate = evaluate
    after = graphs.counters.as_dict()
    optimizer, generator = result.optimizer, result.generator
    best = result.halls_of_fame[-1][0]
    expr = optimizer.compile_individual(best)[0]
    during = measured.get(canonical_string(expr))
    again = generator.generate_and_evaluate(expr, evaluation_samples=1)
    launched = check_no_launch(failures, "fas_evolve")
    evaluations = optimizer._total_number_of_evaluations
    emit({
        "phase": "fas_evolve", "args": " ".join(FAS_EVOLVE_ARGS[:-2]),
        "evaluations": evaluations, "evolution_s": result.evolution_s,
        "evals_per_hour": evaluations / result.evolution_s * 3600.0,
        # The per-structure FAS stage graphs (captured during the run).
        "graphs": {"captures": after["captures"] - before["captures"],
                   "capture_s": after["capture_s"] - before["capture_s"],
                   "capture_share_of_wall": (after["capture_s"] - before["capture_s"])
                   / result.evolution_s,
                   "bytes_held": generator.graph_cache.bytes_held},
        "vm_stats": generator.vm_stats(),
        "best": {"fitness": list(best.fitness_values),
                 "during": list(during) if during else None, "reevaluated": list(again)},
        "rb_sweep_launches": launched, "phase_s": time.perf_counter() - start,
    })
    check_results(failures, "fas_evolve", [again])
    if not (math.isfinite(best.fitness_values[0]) and best.fitness_values[0] < 1e50):
        failures.append(f"fas_evolve: best fitness {best.fitness_values}")
    if during is None or abs(during[2] - again[2]) > 1:
        failures.append(f"fas_evolve: the best individual had {during} during the run "
                        f"and {again} evaluated again")
    return launched


def phase_profile_families(failures: list) -> None:
    """One evaluation and one cycle of the tuned variable-coefficient
    champion (511², float32) and of the tuned 3D champion (127³, float32);
    one cycle of the FAS champion (511², float32), whose evaluation is
    timed in the fas phase."""
    configurations = {
        "varcoeff_511": (poisson.poisson_2d_variable(5, 9, dtype=torch.float32),
                         VARCOEFF_CHAMPION, True),
        "poisson3d_127": (poisson.poisson_3d(3, 7, dtype=torch.float32), POISSON3D_CHAMPION, True),
        "fas_511": (fas.fas_2d(5, 9, dtype=torch.float32), FAS_CHAMPION, False),
    }
    for name, (problem, path, evaluate) in configurations.items():
        generator = TorchProgramGenerator(problem, dtype=torch.float32, device=DEVICE)
        expr = artifact_expression(problem, path, evaluate, failures)
        record = {"phase": "profile_families", "family": name}
        if evaluate:
            evaluation = profile_run(
                lambda: generator.generate_and_evaluate(expr, evaluation_samples=1),
                f"profile_{name}_eval.txt", host_ops=False)
            record["evaluation"] = {k: v for k, v in evaluation.items() if k != "events"}
        step = generator.lowering.lower(expr)
        u, f = problem.initial_state(torch.float32, device=DEVICE)
        cycle = profile_run(lambda: step(u, f), f"profile_{name}_cycle.txt")
        record["one_cycle"] = {k: v for k, v in cycle.items() if k != "events"}
        record["device_ops_per_cycle"] = cycle["device_ops"]
        emit(record)
        if not cycle["device_ops"]:
            failures.append(f"profile_families {name}: no operation ran on the device")


# ---------------------------------------------------------------------------
# The staged deep solves and the models.
# ---------------------------------------------------------------------------

PAPER_CHAMPION = os.path.join(ARTIFACTS, "paper_protocol", "individual_1_tuned.txt")
# --repeats cut from the script's 9 to 3 to fit this script's time limit.
HEADLINE_ARGS = [
    "--min-level", "6", "--max-level", "10", "--predicted", "--repeats", "3",
    "--champion", PAPER_CHAMPION, "--compare-eager",
    "--json", os.path.join(ROOT, "chiprun_out", "headline_1023.json"),
]
# RESULTS.md R5.8: scripts/headline_1024.py --predicted on one TPU v5e.  A
# cross-check printed beside the card's rows, not a target.
TPU_R58 = {
    "textbook V(2,1)": {"rho": 0.080, "cycles": 21, "per_cycle_us": 284.5, "device_ms": 6.33},
    "textbook V(2,2)": {"rho": 0.061, "cycles": 17, "per_cycle_us": 308.2, "device_ms": 5.60},
    "individual_1_tuned (tuned ω)": {"rho": 0.0615, "cycles": 18, "per_cycle_us": 230.7,
                                     "device_ms": 4.51},
}
# The smoothed levels of the headline's cycles; 63², its coarsest, takes the
# dense solve.
HEADLINE_LEVELS = [(127, 127), (255, 255), (511, 511), (1023, 1023)]


def _textbook_solver(problem, pre, post, device, lowering=CycleLowering, **kwargs):
    """staged_solver_for_expression on textbook V(pre, post), its float32
    cycle lowered by `lowering`: (solve, f32 right-hand side, f64
    right-hand side, ρ or None)."""
    pset, terminal_list = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension,
        problem.coarsening_factors, problem.max_level, problem.equations,
        problem.operators, problem.fields, depth=problem.max_level - problem.min_level,
        maximum_local_system_size=8)
    expr = reference_cycles.generate_v_cycle(terminal_list, problem.rhs(), pre, post)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device=device)
    rho = None
    if kwargs.pop("predicted", False):
        rho = generator.generate_and_evaluate(expr, evaluation_samples=1)[1]
        kwargs.update(rho=rho, calibrate_floor=True)
    solve, f64_rhs = staged_solver_for_expression(
        lowering(torch.float32, device), expr, terminal_list[0].operator, problem,
        generator, lowering64=CycleLowering(torch.float64, device, use_kernels=False),
        target=1e-10, **kwargs)
    _, f32 = problem.initial_state(torch.float32, device=device)
    return solve, f32, f64_rhs, rho


def _solve_walls(solve, f32, f64_rhs, repeats: int = 3) -> tuple:
    """(result, wall ms of the first solve, min and median wall ms of
    `repeats` more)."""
    t0 = time.perf_counter()
    result = solve(f32, f64_rhs)
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = solve(f32, f64_rhs)
        times.append(time.perf_counter() - t0)
    times.sort()
    return result, 1e3 * first, 1e3 * times[0], 1e3 * times[len(times) // 2]


def phase_headline(failures: list) -> dict:
    """scripts/torch_headline_1024.py at 1023² (levels 6-10) with --predicted
    and --compare-eager: textbook V(2,1), V(2,2) and the paper champion with
    its stored ω, each solved on CUDA graphs (the default) and with
    cuda_graphs=False; then the fused V(2,2) with no ρ
    (build_fused_staged_solver) both ways.  Returns the kernel's launches
    by grid shape over all of them.  Then, outside that count, a predicted
    V(2,2) at 255² on the card and on the CPU."""
    start = time.perf_counter()
    rb_sweep.launches.clear()
    rows = torch_headline_1024.run(HEADLINE_ARGS)
    problem = poisson_2d(min_level=6, max_level=10, dtype=torch.float32)
    fused = {}
    for mode in (True, False):
        solve, f32, f64_rhs, _ = _textbook_solver(problem, 2, 2, DEVICE, fused=True,
                                                  cuda_graphs=mode)
        (cycles, rel, stages), first, t_min, t_med = _solve_walls(solve, f32, f64_rhs)
        fused["graphs" if mode else "eager"] = {
            "cycles": cycles, "rel": rel, "stages": stages, "first_wall_ms": first,
            "wall_min_ms": t_min, "wall_med_ms": t_med, **solve.graphs}
        del solve
    torch.cuda.synchronize()
    by_shape = dict(rb_sweep.launches)

    repeats = {}
    for device in (DEVICE, "cpu"):
        solve, f32, f64_rhs, rho = _textbook_solver(
            poisson_2d(min_level=4, max_level=8, dtype=torch.float32), 2, 2, device,
            predicted=True)
        cycles, rel, stages = solve(f32, f64_rhs)
        repeats[device] = {"rho": rho, "cycles": cycles, "stages": stages, "rel": rel,
                           "measured_floor": solve.measured_floor}
    emit({
        "phase": "headline", "args": " ".join(HEADLINE_ARGS[:-2]),
        "rows": rows,
        "tpu_r58_cross_check": TPU_R58,
        "fused_v22": fused,
        "predicted_v22_255": repeats,
        "rb_sweep_launches_by_shape": launches_record(by_shape),
        "phase_s": time.perf_counter() - start,
    })
    for row in rows:
        if not row["rel_residual"] <= 1e-10:
            failures.append(f"headline {row['solver']}: rel {row['rel_residual']} > 1e-10")
        if not (math.isfinite(row["t_cycle_us"]) and row["t_cycle_us"] > 0):
            failures.append(f"headline {row['solver']}: device time per cycle {row['t_cycle_us']}")
        if not (row["captures"] > 0 and row["eager"]["bitwise_equal"]):
            failures.append(f"headline {row['solver']}: {row['captures']} captures; on graphs "
                            f"{(row['cycles'], row['rel_residual'], row['stages'])}, eagerly "
                            f"{row['eager']}")
    if len(rows) != 3:
        failures.append(f"headline: {len(rows)} solvers instead of 3")
    graph, eager = fused["graphs"], fused["eager"]
    if not graph["rel"] <= 1e-10:
        failures.append(f"headline: fused V(2,2) rel {graph['rel']} > 1e-10")
    if not (graph["captures"] > 0 and all(graph[k] == eager[k]
                                          for k in ("cycles", "rel", "stages"))):
        failures.append(f"headline: fused V(2,2) on graphs {graph}, eagerly {eager}")
    for shape in HEADLINE_LEVELS:
        if not by_shape.get(shape):
            failures.append(f"headline: no kernel launch at {shape[0]}x{shape[1]}")
    card, cpu = repeats[DEVICE], repeats["cpu"]
    if not (card["rel"] <= 1e-10 and cpu["rel"] <= 1e-10
            and abs(card["cycles"] - cpu["cycles"]) <= 2
            and abs(card["stages"] - cpu["stages"]) <= 1):
        failures.append(f"headline: predicted V(2,2) at 255² card {card} vs CPU {cpu}")
    return by_shape


MODEL_BASED_ARGS = [
    "--problem", "poisson2d", "--method", "nsga2", "--mu", "4", "--lambda", "4",
    "--generations", "2", "--min-level", "5", "--max-level", "9", "--dtype", "float32",
    "--model-based", "--seed", "3",
    "--output", os.path.join(ROOT, "chiprun_out", "model_based"),
]
CALIBRATION_511 = ("V(2,1)_rb_512", "V(2,2)_rb_512", "V(2,2)_jacobi_512", "smooth4_rb_512")


def phase_models(failures: list, champion_rho: float) -> None:
    """LFA ρ beside measured ρ; a model-based NSGA-II run through the entry
    point; the roofline's prediction of the calibration cases at 511²
    against their device time on the card (within 2×)."""
    from evostencils_torch.models.lfa import ConvergenceEvaluator
    from evostencils_torch.models.roofline import PerformanceEvaluator

    start = time.perf_counter()
    record = {"phase": "models"}
    # LFA: the textbook V(2,2) two-grid cycle at 63² (levels 5-6, the 31²
    # coarse grid solved dense) beside its measured ρ; the bench champion
    # (five levels) beside the main path's ρ.  LFA models at most two
    # levels cheaply, as the reference (scripts/optimize.py:101-103).
    two_grid = poisson_2d(min_level=5, max_level=6, dtype=torch.float32)
    _, terminal_list = generate_primitive_set(
        two_grid.approximation(), two_grid.rhs(), 2, two_grid.coarsening_factors, 6,
        two_grid.equations, two_grid.operators, two_grid.fields, depth=1,
        maximum_local_system_size=8)
    v22 = reference_cycles.generate_v_cycle(terminal_list, two_grid.rhs(), 2, 2)
    lfa = ConvergenceEvaluator(2, two_grid.coarsening_factors, two_grid.finest_grid)
    measured_v22 = TorchProgramGenerator(two_grid, dtype=torch.float32, device=DEVICE)\
        .generate_and_evaluate(v22, evaluation_samples=1)[1]
    bench = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
    champion, _ = load_champion(bench_pset(bench))
    t0 = time.perf_counter()
    lfa_champion = ConvergenceEvaluator(
        2, bench.coarsening_factors, bench.finest_grid, samples_per_axis=2,
    ).compute_spectral_radius(champion)
    record["lfa"] = {
        "textbook_v22_two_grid_63": {"lfa": lfa.compute_spectral_radius(v22),
                                      "measured": measured_v22},
        # 0.0 is LFA's poison: the champion's 3×1 block has a period the
        # frequency classes of a power-of-2 hierarchy cannot hold.
        "bench_champion": {"lfa": lfa_champion, "measured": champion_rho,
                           "lfa_s": time.perf_counter() - t0},
    }

    t0 = time.perf_counter()
    result = torch_optimize.run(MODEL_BASED_ARGS)
    halls = [[list(ind.fitness_values) for ind in hof] for hof in result.halls_of_fame]
    record["model_based"] = {"args": " ".join(MODEL_BASED_ARGS[:-2]),
                             "evaluations": result.optimizer._total_number_of_evaluations,
                             "halls_of_fame": halls, "s": time.perf_counter() - t0}
    if not any(0.0 < rho < 1.0 and runtime > 0.0 for hof in halls for rho, runtime in hof):
        failures.append(f"models: no hall of fame holds 0 < ρ < 1 with a runtime: {halls}")

    perf = PerformanceEvaluator()
    cases = {name: (problem, expr) for name, problem, expr in torch_calibrate_roofline.build_cases()
             if name in CALIBRATION_511}
    roofline = {}
    for name, (problem, expr) in cases.items():
        step = CycleLowering(torch.float32, DEVICE).lower(expr)
        u0, f = problem.initial_state(torch.float32, device=DEVICE)
        measured = per_cycle_time(step, u0, f, iters=50, repeats=3)
        predicted = perf.estimate_runtime(expr)
        roofline[name] = {"measured_s": measured, "predicted_s": predicted,
                          "ratio": predicted / measured}
        if not 0.5 <= predicted / measured <= 2.0:
            failures.append(f"models: roofline {name} predicted/measured "
                            f"{predicted / measured:.3f} outside 2×")
    record["roofline_511"] = roofline
    record["phase_s"] = time.perf_counter() - start
    emit(record)


# ---- problem files, the champion scripts and population dispatch ----

SPECS = os.path.join(ARTIFACTS, "problem_specs")
POISSON_SPEC = os.path.join(SPECS, "2D_FD_Poisson_fromL2.exa2")
FAS_SPEC = os.path.join(SPECS, "FAS_2D_Basic_template.exa4")
EXAFILE_CHAMPIONS = {
    "untuned": os.path.join(ARTIFACTS, "exafile_poisson_champion_r5.txt"),
    "tuned": os.path.join(ARTIFACTS, "exafile_poisson_champion_r5_tuned.txt"),
}
# RESULTS.md R5.5: the TPU's evolution driven by the reference's .exa2 file,
# 3 samples at 511².  A cross-check printed beside the card's numbers.
R55_TPU_RECORD = {"untuned": {"rho": 0.1703, "iterations": 16},
                  "tuned": {"rho": 0.0802, "iterations": 11}}
PROBLEM_FILE_ARGS = [
    "--problem-file", POISSON_SPEC, "--method", "nsga2", "--mu", "4", "--lambda", "4",
    "--generations", "1", "--population-initialization-factor", "2",
    "--evaluation-samples", "1", "--seed", "20260819",
    "--output", os.path.join(ROOT, "chiprun_out", "problem_file"),
]
PAPER_CHAMPION_0 = os.path.join(ARTIFACTS, "paper_protocol", "individual_0.txt")
PAPER_STATS_RECORD = os.path.join(ARTIFACTS, "paper_protocol", "poisson2d_stats_n20_f32.json")
DISPATCH_OMEGAS = (0.7, 0.8, 0.9, 1.0, 1.1, 1.2)
# The first 8 of the bench's 16 trees (cut to fit this script's time limit).
DISPATCH_TREES = 8


def red_black_shapes(path: str, finest_level: int) -> list:
    """The grid shapes at which a stored tree smooths with red-black point
    Jacobi, the kernel's work: `collective_jacobi_<i>(rf_n,red_black,...)`
    at level index i below the finest."""
    tree_string = parse_champion_file(path)[0]
    indices = {int(i) for i in re.findall(
        r"collective_jacobi_(\d+)(?:__\d+)?\(rf_\d+,red_black", tree_string)}
    return sorted((2 ** (finest_level - i) - 1,) * 2 for i in indices)


def add_launches(total: dict, launched: dict) -> None:
    for shape, count in launched.items():
        total[shape] = total.get(shape, 0) + count


def launches_record(by_shape: dict) -> dict:
    return {shape_label(shape): n for shape, n in sorted(by_shape.items())}


def phase_problem_file(failures: list) -> dict:
    """The exafile champion on the problem parsed from the .exa2 spec and on
    poisson_2d(5, 9), then an NSGA-II run from the spec; returns the
    kernel's launches by grid shape over the phase."""
    start = time.perf_counter()
    phase_launches = {}
    parsed = load_problem_file(POISSON_SPEC)
    problems = {"parsed": parsed, "poisson_2d": poisson_2d(5, 9, dtype=torch.float32)}
    record = {"phase": "problem_file", "spec": os.path.relpath(POISSON_SPEC, ROOT),
              "levels": [parsed.min_level, parsed.max_level], "dtype": str(parsed.dtype)}
    if (parsed.min_level, parsed.max_level, parsed.dtype) != (5, 9, torch.float32):
        failures.append(f"problem_file: the spec loaded as {record}")
    for label, path in EXAFILE_CHAMPIONS.items():
        # 127²-511² for the exafile champion: at 63² it smooths with
        # single-colour and block Jacobi only.
        expected = red_black_shapes(path, parsed.max_level)
        entry = {"red_black_levels": [f"{r}x{c}" for r, c in expected]}
        for name, problem in problems.items():
            expr = artifact_expression(problem, path, label == "tuned", failures)
            generator = TorchProgramGenerator(problem, device=DEVICE)
            rb_sweep.launches.clear()
            entry[name] = timed_evaluation(generator, expr, samples=1)
            launched = dict(rb_sweep.launches)
            add_launches(phase_launches, launched)
            entry[name]["rb_sweep_launches_by_shape"] = launches_record(launched)
            check_contracts(failures, f"problem_file {label} {name}", entry[name])
            check_results(failures, f"problem_file {label} {name}", [
                (entry[name]["time_to_target_ms"] or math.inf, entry[name]["rho"],
                 entry[name]["iterations"])])
            for shape in expected:
                if not launched.get(shape):
                    failures.append(f"problem_file {label} {name}: no kernel launch at "
                                    f"{shape[0]}x{shape[1]}")
        a, b = entry["parsed"], entry["poisson_2d"]
        if not expected:
            failures.append(f"problem_file {label}: the champion has no red-black smoother")
        if (a["rho"], a["iterations"]) != (b["rho"], b["iterations"]):
            failures.append(f"problem_file {label}: parsed rho {a['rho']} in {a['iterations']} "
                            f"vs poisson_2d {b['rho']} in {b['iterations']}")
        if a["rb_sweep_launches_by_shape"] != b["rb_sweep_launches_by_shape"]:
            failures.append(f"problem_file {label}: launches {a['rb_sweep_launches_by_shape']} "
                            f"vs poisson_2d {b['rb_sweep_launches_by_shape']}")
        entry["tpu_r5_5_record"] = R55_TPU_RECORD[label]
        record[label] = entry

    rb_sweep.launches.clear()
    t0 = time.perf_counter()
    result = torch_optimize.run(PROBLEM_FILE_ARGS)
    torch.cuda.synchronize()
    launched = dict(rb_sweep.launches)
    add_launches(phase_launches, launched)
    halls = [[list(ind.fitness_values) for ind in hof] for hof in result.halls_of_fame]
    record["evolve"] = {
        "args": " ".join(PROBLEM_FILE_ARGS[2:-2]),
        "problem": result.generator.problem.name,
        "evaluations": result.optimizer._total_number_of_evaluations,
        "evolution_s": result.evolution_s, "s": time.perf_counter() - t0,
        "best_rho": min((rho for hof in halls for rho, _ in hof), default=None),
        "rb_sweep_launches_by_shape": launches_record(launched),
    }
    if not any(0.0 < rho < 1.0 for hof in halls for rho, _ in hof):
        failures.append(f"problem_file: no hall of fame holds 0 < ρ < 1: {halls}")
    if not launched:
        failures.append("problem_file: the evolution from the spec never launched the kernel")
    record["rb_sweep_launches"] = sum(phase_launches.values())
    record["phase_s"] = time.perf_counter() - start
    emit(record)
    return phase_launches


def phase_problem_file_fas(failures: list) -> int:
    """The FAS champion on the parsed FAS template and on fas_2d at levels
    5-9: both converge, ρ within 5 % and iterations within ±1 (the parsed
    Jacobian 20·u·eᵘ + 20·eᵘ rounds otherwise than γ(1+u)eᵘ, and FAS ρ comes
    from the stall rule), and the gate refuses the nonlinear operator."""
    start = time.perf_counter()
    rb_sweep.launches.clear()
    parsed = load_problem_file(FAS_SPEC).with_levels(5, 9)
    results = {
        "parsed": grammar_entry_evaluation(parsed, DEVICE, FAS_CHAMPION, samples=1),
        "fas_2d": grammar_entry_evaluation(fas.fas_2d(5, 9, dtype=torch.float32), DEVICE,
                                           FAS_CHAMPION, samples=1),
    }
    launched = check_no_launch(failures, "problem_file_fas")
    emit({"phase": "problem_file_fas", "spec": os.path.relpath(FAS_SPEC, ROOT),
          "levels": [5, 9], "dtype": str(parsed.dtype), **results,
          "rb_sweep_launches": launched, "phase_s": time.perf_counter() - start})
    for name, result in results.items():
        check_contracts(failures, f"problem_file_fas {name}", result)
        if result["time_to_target_ms"] is None:
            failures.append(f"problem_file_fas {name}: did not converge")
    a, b = results["parsed"], results["fas_2d"]
    if not abs(a["rho"] - b["rho"]) <= 0.05 * b["rho"]:
        failures.append(f"problem_file_fas: rho {a['rho']} vs fas_2d {b['rho']} beyond 5 %")
    if not abs(a["iterations"] - b["iterations"]) <= 1:
        failures.append(f"problem_file_fas: {a['iterations']} vs {b['iterations']} iterations")
    return launched


def phase_scripts(failures: list) -> dict:
    """The four champion scripts in this process at levels 5-9 (511²),
    float32; returns the kernel's launches by grid shape over them."""
    start = time.perf_counter()
    phase_launches = {}
    record = {"phase": "scripts"}
    out = os.path.join(ROOT, "chiprun_out")
    runs = {
        "evaluate_reference_solver": (torch_evaluate_reference_solver, [
            "--pre", "2", "--post", "1", "--samples", "3"]),
        "evaluate_evolved_solver": (torch_evaluate_evolved_solver, [
            EXAFILE_CHAMPIONS["untuned"], "--evaluation-samples", "3"]),
        "champion_stats": (torch_champion_stats, [
            os.path.join(ARTIFACTS, "paper_protocol", "individual_0_tuned.txt"),
            "--samples", "20", "--json", os.path.join(out, "poisson2d_stats_n20_cuda.json")]),
        "tune_champions": (torch_tune_champions, [
            PAPER_CHAMPION_0, "--iterations", "10", "--samples", "1",
            "--output-dir", os.path.join(out, "tuned")]),
    }
    results = {}
    for name, (module, argv) in runs.items():
        rb_sweep.launches.clear()
        t0 = time.perf_counter()
        results[name] = module.run(argv)
        torch.cuda.synchronize()
        launched = dict(rb_sweep.launches)
        add_launches(phase_launches, launched)
        record[name] = {"args": " ".join(os.path.relpath(a, ROOT) if os.path.isabs(a) else a
                                         for a in argv),
                        "s": time.perf_counter() - t0,
                        "rb_sweep_launches_by_shape": launches_record(launched)}
        if not launched:
            failures.append(f"scripts: {name} never launched the kernel")

    for name in ("evaluate_reference_solver", "evaluate_evolved_solver"):
        result = results[name]
        record[name].update(result)
        if not 0.0 < result["convergence_factor"] < 1.0 or not result["time_to_convergence_ms"] < 1e50:
            failures.append(f"scripts: {name} gave {result}")

    with open(PAPER_STATS_RECORD) as f:
        stored = json.load(f)["champions"][0]
    (entry,) = results["champion_stats"]["champions"]
    record["champion_stats"]["card"] = {
        label: {key: entry[label][key]["median"] for key in ("rho", "iterations",
                                                            "time_to_target_ms")}
        for label in ("untuned", "tuned")}
    record["champion_stats"]["cpu_record_of_the_jax_package"] = {
        label: {key: stored[label][key]["median"] for key in ("rho", "iterations")}
        for label in ("untuned", "tuned")}
    for label in ("untuned", "tuned"):
        card, cpu = entry[label], stored[label]
        if not abs(card["rho"]["median"] - cpu["rho"]["median"]) <= 0.02 * cpu["rho"]["median"]:
            failures.append(f"scripts: champion_stats {label} median rho "
                            f"{card['rho']['median']} vs record {cpu['rho']['median']}")
        if not abs(card["iterations"]["median"] - cpu["iterations"]["median"]) <= 1:
            failures.append(f"scripts: champion_stats {label} median iterations "
                            f"{card['iterations']['median']} vs {cpu['iterations']['median']}")

    (tuned,) = results["tune_champions"]
    record["tune_champions"].update(
        {key: tuned[key] for key in ("rho_before", "rho_after", "iterations_before",
                                     "iterations_after")})
    tree_string, omegas = parse_champion_file(tuned["output"])
    bench = poisson_2d(5, 9, dtype=torch.float32)
    pset = family_pset(bench)
    expr = gp.compile_tree(gp.parse_tree(tree_string, pset), pset)[0]
    if not (omegas and apply_stored_omegas(expr, omegas, label=tuned["output"])):
        failures.append(f"scripts: the tuned file {tuned['output']} does not apply its omegas")
    record["rb_sweep_launches"] = sum(phase_launches.values())
    record["phase_s"] = time.perf_counter() - start
    emit(record)
    return phase_launches


_MULTIHOST_WORKER = """
import json, sys
import torch
import torch.distributed as dist

rank, address, device = int(sys.argv[1]), sys.argv[2], sys.argv[4]
omegas = [float(w) for w in sys.argv[3].split(",")]
dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=rank, world_size=2)
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.ops import rb_sweep
from evostencils_torch.parallel.dispatch import MultiHostDispatcher, SerialDispatcher
from evostencils_torch.problems.poisson import poisson_2d

problem = poisson_2d(5, 9, dtype=torch.float32)
_, terminals = generate_primitive_set(
    problem.approximation(), problem.rhs(), 2, problem.coarsening_factors, 9,
    problem.equations, problem.operators, problem.fields, depth=4)
cycles = [generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=w) for w in omegas]
dispatcher = MultiHostDispatcher(inner=SerialDispatcher())
generator = TorchProgramGenerator(problem, device=device)
gathered = dispatcher.map(lambda c: generator.generate_and_evaluate(c, evaluation_samples=1),
                          cycles)
if device == "cuda":
    torch.cuda.synchronize()
launches = rb_sweep.launches.total()
local = TorchProgramGenerator(problem, device=device)
serial = [local.generate_and_evaluate(c, evaluation_samples=1) for c in cycles]
same = [(g[1], g[2]) == (s[1], s[2]) for g, s in zip(gathered, serial)]
print(json.dumps({"rank": rank, "gathered": [list(g) for g in gathered],
                  "serial": [list(s) for s in serial], "same": same,
                  "launches_in_dispatch": launches}), flush=True)
dist.destroy_process_group()
sys.exit(0 if all(same) else 1)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dispatch(failures: list) -> dict:
    """The 16 bench trees at 511² through the optimizer's evaluation path
    with SerialDispatcher and ThreadPoolDispatcher(2); then
    MultiHostDispatcher in two processes on this card.  Returns the
    kernel's launches by grid shape in this process."""
    start = time.perf_counter()
    phase_launches = {}
    problem = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
    pset = bench_pset(problem)
    rng = random.Random(20260816)
    trees = [gp.gen_grow(pset, 2, 16, rng=rng) for _ in range(DISPATCH_TREES)]
    warm = gp.gen_grow(pset, 2, 10, rng=rng)
    record = {"phase": "dispatch", "n_individuals": len(trees)}
    runs = {}
    for name, dispatcher in (("serial", SerialDispatcher()),
                             ("threads_2", ThreadPoolDispatcher(max_workers=2))):
        generator = TorchProgramGenerator(problem, iteration_limit=500, device=DEVICE)
        generator.generate_and_evaluate(gp.compile_tree(warm, pset)[0], evaluation_samples=1)
        optimizer = Optimizer.for_problem(problem, program_generator=generator,
                                          rng=random.Random(0), dispatcher=dispatcher)
        optimizer._pset = pset
        optimizer._n_objectives = 2
        optimizer._measured_evaluation = True
        # The fitness keeps ρ and time per iteration; record the counts too.
        measured = {}
        evaluate_inner = generator.generate_and_evaluate

        def recording(expression, _inner=evaluate_inner, _measured=measured, **kwargs):
            result = _inner(expression, **kwargs)
            _measured[canonical_string(expression)] = result
            return result

        generator.generate_and_evaluate = recording
        individuals = [gp.parse_tree(str(tree), pset) for tree in trees]
        torch.cuda.synchronize()
        rb_sweep.launches.clear()
        t0 = time.perf_counter()
        optimizer._evaluate_population(
            individuals,
            lambda ind, _o=optimizer: _o.evaluate_multiple_objectives(ind, evaluation_samples=1),
            evaluation_samples=1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launched = dict(rb_sweep.launches)
        add_launches(phase_launches, launched)
        per_tree = []
        for individual in individuals:
            key = canonical_string(optimizer.compile_individual(individual)[0])
            t, rho, iterations = measured.get(key, (math.nan,) * 3)
            per_tree.append((rho, iterations))
        runs[name] = {"per_tree": per_tree, "launches": launched}
        record[name] = {"elapsed_s": elapsed, "evals_per_hour": len(trees) / elapsed * 3600.0,
                        "evaluated": len(measured), "vm_stats": generator.vm_stats(),
                        "rb_sweep_launches_by_shape": launches_record(launched)}
    if runs["serial"]["per_tree"] != runs["threads_2"]["per_tree"]:
        failures.append(f"dispatch: threads {runs['threads_2']['per_tree']} vs serial "
                        f"{runs['serial']['per_tree']}")
    if runs["serial"]["launches"] != runs["threads_2"]["launches"]:
        failures.append(f"dispatch: launches {runs['threads_2']['launches']} vs serial "
                        f"{runs['serial']['launches']}")
    if not runs["serial"]["launches"]:
        failures.append("dispatch: the kernel never launched")
    record["per_tree"] = runs["serial"]["per_tree"]
    record["thread_pool_speedup"] = (record["serial"]["elapsed_s"]
                                     / record["threads_2"]["elapsed_s"])

    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST_WORKER, str(rank), address,
         ",".join(str(w) for w in DISPATCH_OMEGAS), DEVICE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for rank in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    workers = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outputs)):
        lines = [line for line in out.splitlines() if line.startswith("{")]
        workers.append(json.loads(lines[-1]) if lines else {"rank": rank})
        if p.returncode != 0 or not lines:
            failures.append(f"dispatch: multihost process {rank} exited {p.returncode}: "
                            f"{(out + err)[-1500:]}")
    gathered = [w.get("gathered") for w in workers]
    if gathered[0] != gathered[1]:
        failures.append("dispatch: the two processes gathered different lists")
    record["multihost"] = {"processes": 2, "omegas": list(DISPATCH_OMEGAS),
                           "s": time.perf_counter() - t0, "workers": workers}
    record["rb_sweep_launches"] = sum(phase_launches.values())
    record["phase_s"] = time.perf_counter() - start
    emit(record)
    return phase_launches


MESH_SCRIPT = os.path.join(ROOT, "scripts", "torch_mesh_dryrun.py")


def _mesh_run(backend: str, ranks: int, compare: bool, extra=()) -> tuple:
    """scripts/torch_mesh_dryrun.py under torchrun with `extra` arguments:
    (exit code, the ranks' JSON records, the output's tail)."""
    command = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(ranks),
               "--master_port", str(_free_port()), MESH_SCRIPT, "--backend", backend,
               "--timeout", "120"] + (["--compare"] if compare else []) + list(extra)
    # A session of its own: on a timeout the launcher and its ranks go
    # together.
    proc = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return None, [], "timed out after 400 s"
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return proc.returncode, sorted(records, key=lambda r: r["rank"]), (out + err)[-2000:]


def _mesh_configs() -> list:
    """(backend, ranks) of the mesh runs: one NCCL rank per card on two or
    more cards; on one card 2 gloo ranks (NCCL refuses two ranks on one
    GPU) and 1 NCCL rank."""
    cards = torch.cuda.device_count()
    return [("nccl", cards)] if cards >= 2 else [("gloo", 2), ("nccl", 1)]


def _mesh_family_runs(failures: list, problem: str, extra: list, compare: bool,
                      configs=None) -> list:
    """scripts/torch_mesh_dryrun.py --problem `problem` on `configs` (every
    mesh configuration by default), the first with --compare when
    `compare`: [(backend, ranks, records, seconds)] of the runs that exited
    0 with a record per rank; the others are failures."""
    runs = []
    for index, (backend, ranks) in enumerate(_mesh_configs() if configs is None else configs):
        t0 = time.perf_counter()
        rc, records, tail = _mesh_run(backend, ranks, compare and index == 0,
                                      ["--problem", problem] + extra)
        if rc != 0 or len(records) != ranks:
            failures.append(f"mesh {problem}: {backend} × {ranks} exited {rc} with "
                            f"{len(records)} records: {tail}")
            continue
        runs.append((backend, ranks, records, time.perf_counter() - t0))
    return runs


def _iteration_fields(result: dict) -> dict:
    return {k: result.get(k) for k in ("rho", "iterations", "converged", "ms_to_target",
                                       "ms_per_iteration", "probe", "probe_iterations",
                                       "stages", "kernel_launches")}


def mesh_fas(failures: list) -> tuple:
    """(a) FAS at 511², float32, levels 5-9, `replicate_below` 64: the
    stored champion and the textbook Newton V(2,2) on the mesh; the first
    run's rank 0 evaluates both unsharded.  The champion must agree (ρ 2 %,
    ±1); the textbook's ρ comes from the stall rule: printed."""
    record, launches, unsharded = {"runs": []}, 0, None
    for backend, ranks, records, seconds in _mesh_family_runs(
            failures, "fas", ["--replicate-below", "64"], compare=True):
        b = records[0]["B"]
        unsharded = records[0].get("unsharded", unsharded)
        run = {"backend": backend, "ranks": ranks, "s": seconds, "route": b["route"],
               "sharded_levels": b["sharded_levels"], "counts": b["counts"],
               "cycles": {name: _iteration_fields(c) for name, c in b["cycles"].items()}}
        record["runs"].append(run)
        run_launches = [c["kernel_launches"] for r in records for c in r["B"]["cycles"].values()]
        launches += sum(run_launches)
        if any(run_launches):
            failures.append(f"mesh fas: {backend} × {ranks} launched the kernel {run_launches}")
        verdicts = [{n: (c["rho"], c["iterations"]) for n, c in r["B"]["cycles"].items()}
                    for r in records]
        if any(v != verdicts[0] for v in verdicts):
            failures.append(f"mesh fas: the ranks of {backend} × {ranks} disagree")
        if unsharded is None:
            failures.append("mesh fas: no unsharded run to compare with")
            continue
        mesh, plain = b["cycles"]["champion"], unsharded["champion"]
        if not (abs(mesh["rho"] - plain["rho"]) <= 0.02 * plain["rho"]
                and abs(mesh["iterations"] - plain["iterations"]) <= 1):
            failures.append(f"mesh fas: {backend} × {ranks} champion {mesh['rho']} / "
                            f"{mesh['iterations']} vs unsharded {plain['rho']} / "
                            f"{plain['iterations']}")
    record["unsharded"] = None if unsharded is None else {
        name: _iteration_fields(c) for name, c in unsharded.items()}
    return record, launches


def mesh_helmholtz(failures: list, unsharded: dict, configs: list) -> tuple:
    """(b) Helmholtz, complex128, levels 3-7, k = 80, the textbook V(2,1)
    ω 0.6, the outer cap cut to LADDER_CAP as the helmholtz phase's, and
    `replicate_below` 16, so that 127² and 63² are split, on `configs`;
    `unsharded` is the helmholtz phase's k = 80 rung on this card.  Each
    run must converge with the unsharded probe verdict and stages, the
    count within 10 %.  Returns (the runs' records, launches)."""
    runs, launches = [], 0
    for backend, ranks, records, seconds in _mesh_family_runs(
            failures, "helmholtz",
            ["--replicate-below", "16", "--outer-cap", str(LADDER_CAP)], compare=False,
            configs=configs):
        b = records[0]["B"]
        run = {"backend": backend, "ranks": ranks, "s": seconds, "route": b["route"],
               "sharded_levels": b["sharded_levels"], "counts": b["counts"],
               "ms_per_outer_iteration": b["ms_per_iteration"], **_iteration_fields(b)}
        runs.append(run)
        run_launches = [r["B"]["kernel_launches"] for r in records]
        launches += sum(run_launches)
        if any(run_launches):
            failures.append(f"mesh helmholtz: {backend} × {ranks} launched the kernel "
                            f"{run_launches}")
        if any((r["B"]["rho"], r["B"]["iterations"]) != (b["rho"], b["iterations"])
               for r in records):
            failures.append(f"mesh helmholtz: the ranks of {backend} × {ranks} disagree")
        if not (b["converged"] and unsharded["converged"]
                and (b["probe"], b["stages"]) == (unsharded["probe"], unsharded["stages"])
                and abs(b["iterations"] - unsharded["iterations"])
                <= 0.1 * unsharded["iterations"]):
            failures.append(f"mesh helmholtz: {backend} × {ranks} {_iteration_fields(b)} vs "
                            f"unsharded {unsharded}")
    return runs, launches


# One rank of scripts/torch_optimize.py on a mesh: argv after the rank, the
# world size and the port.  Every generate_and_evaluate is recorded by the
# canonical string of its cycle (a string of this process: its stencil
# fingerprints hash per process), so the halls of fame leave with the
# fitness this rank measured for each, if it evaluated it; one JSON line at
# the end.
_OPTIMIZE_RANK = """
import json, os, sys
rank, world, port, argv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4:]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                  WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
argv[argv.index("--output") + 1] += f"_rank{rank}"
import datetime
import torch.distributed as dist
# gloo: several ranks on one card, which NCCL refuses.
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=600))
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.ops import rb_sweep
from scripts import torch_optimize

measured = {}
evaluate = TorchProgramGenerator.generate_and_evaluate

def recording(self, expression, *args, **kwargs):
    result = evaluate(self, expression, *args, **kwargs)
    measured[canonical_string(expression)] = list(result)
    return result

TorchProgramGenerator.generate_and_evaluate = recording
run = torch_optimize.run(argv)
hof_measured = [[str(i), measured.get(canonical_string(run.optimizer.compile_individual(i)[0]))]
                for hof in run.halls_of_fame for i in hof]
print(json.dumps({
    "rank": rank, "best": run.best, "tuning": run.tuning,
    "logbooks": [[{k: v for k, v in r.items() if k != "gen_s"} for r in lb.records]
                 for lb in run.logbooks],
    "halls_of_fame": [[[str(i), list(i.fitness_values)] for i in hof]
                      for hof in run.halls_of_fame],
    "evaluations": run.optimizer._total_number_of_evaluations,
    "evolution_s": run.evolution_s, "hof_measured": hof_measured,
    "counts": dict(run.generator.layout.counts),
    "score_group_is_sp": run.generator.layout.score_group is run.generator.layout.sp_group,
    "kernel_launches": rb_sweep.launches.total()}, default=float), flush=True)
dist.destroy_process_group()
"""

# The rows evaluate different individuals, so a row may wait minutes at the
# gather for the other: the collectives' bound is the ranks' own.
MESH_MULTIHOST_ARGS = [
    "--mesh", "2,2", "--multihost", "--seed", "3", "--method", "nsga2",
    "--mu", "4", "--lambda", "4", "--generations", "1", "--population-initialization-factor",
    "1", "--evaluation-samples", "1", "--min-level", "5", "--max-level", "9",
    "--collective-timeout", "600", "--output", os.path.join(ROOT, "chiprun_out", "mesh_multihost"),
]
MESH_TUNE_ARGS = [
    "--mesh", "1,2", "--tune", "--seed", "3", "--method", "nsga2",
    "--mu", "2", "--lambda", "2", "--generations", "1", "--population-initialization-factor",
    "1", "--evaluation-samples", "1", "--min-level", "3", "--max-level", "6",
    "--replicate-below", "16",
    "--collective-timeout", "120", "--output", os.path.join(ROOT, "chiprun_out", "mesh_tune"),
]


def _start_optimize_ranks(world: int, argv: list) -> list:
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", _OPTIMIZE_RANK, str(rank), str(world), port, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), start_new_session=True)
        for rank in range(world)]


def _finish_optimize_ranks(failures: list, label: str, procs: list, started: float) -> list:
    """Every rank's JSON record, each with `wall_s` since this phase's
    runs started; a rank that fails or stays silent is a failure.  Each
    rank is bounded by 600 s; stragglers are killed."""
    records = []
    deadline = time.perf_counter() + 600
    for rank, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
            out, err = proc.communicate()
        lines = [line for line in out.splitlines() if line.startswith("{")]
        if proc.returncode != 0 or not lines:
            failures.append(f"{label}: rank {rank} exited {proc.returncode}: "
                            f"{(out + err)[-1500:]}")
            continue
        records.append({**json.loads(lines[-1]), "wall_s": time.perf_counter() - started})
    return records


def mesh_multihost(failures: list, records: list) -> dict:
    """(c) scripts/torch_optimize.py --mesh 2,2 --multihost on 4 gloo ranks
    of this card: four identical logbooks, each dp row evaluated its half,
    rank 0 alone wrote; three gathered individuals re-evaluated here
    unsharded with the plain ops, as the mesh runs them: ρ within 1e-4
    relative, iterations ±1 (the reference's bounds,
    tests/test_parallel.py:292-303)."""
    record = {"args": " ".join(MESH_MULTIHOST_ARGS[:-2])}
    if len(records) != 4:
        return record
    first = records[0]
    record.update({
        "wall_s": max(r["wall_s"] for r in records),
        "evaluations_by_rank": [r["evaluations"] for r in records],
        "evolution_s": [r["evolution_s"] for r in records],
        "counts": first["counts"], "score_group_is_sp": first["score_group_is_sp"],
        "kernel_launches": [r["kernel_launches"] for r in records]})
    if any((r["logbooks"], r["halls_of_fame"]) != (first["logbooks"], first["halls_of_fame"])
           for r in records):
        failures.append("mesh multihost: the ranks bred different populations")
    if not all(r["score_group_is_sp"] for r in records):
        failures.append("mesh multihost: a time was not reduced within its dp row")
    rows = record["evaluations_by_rank"]
    if not (rows[0] == rows[1] > 0 and rows[2] == rows[3] > 0):
        failures.append(f"mesh multihost: evaluations by rank {rows}")
    out = MESH_MULTIHOST_ARGS[MESH_MULTIHOST_ARGS.index("--output") + 1]
    written = [os.path.isdir(f"{out}_rank{rank}") for rank in range(4)]
    if written != [True, False, False, False]:
        failures.append(f"mesh multihost: output written by ranks {written}")
    measured = {}
    for r in records:
        for string, fitness in r["hof_measured"]:
            if fitness is not None:
                measured.setdefault(string, fitness)
    levels = [int(MESH_MULTIHOST_ARGS[MESH_MULTIHOST_ARGS.index(flag) + 1])
              for flag in ("--min-level", "--max-level")]
    problem = poisson_2d(*levels, dtype=torch.float32)
    pset = family_pset(problem)
    checked = []
    for string, on_mesh in measured.items():
        if not on_mesh[0] < 1e50 or len(checked) == 3:
            continue
        expression = gp.compile_tree(gp.parse_tree(string, pset), pset)[0]
        generator = TorchProgramGenerator(problem, dtype=torch.float32, device=DEVICE)
        generator.lowering = CycleLowering(torch.float32, DEVICE, use_kernels=False)
        _, rho, iterations = generator.generate_and_evaluate(expression, evaluation_samples=1)
        checked.append({"mesh": on_mesh[1:], "unsharded": [rho, iterations]})
        if not (abs(on_mesh[1] - rho) <= 1e-4 * max(1.0, abs(rho))
                and abs(on_mesh[2] - iterations) <= 1):
            failures.append(f"mesh multihost: {on_mesh} on the mesh vs {rho} / {iterations}")
    record["reevaluated"] = checked
    if len(checked) != 3:
        failures.append(f"mesh multihost: {len(checked)} converged gathered individuals "
                        "re-evaluated, not 3")
    return record


def mesh_tune(failures: list, records: list) -> dict:
    """(d) scripts/torch_optimize.py --mesh 1,2 --tune on 2 gloo ranks:
    both publish rank 0's ω, and either ρ did not grow or the rejected file
    was written, by rank 0 alone."""
    record = {"args": " ".join(MESH_TUNE_ARGS[:-2])}
    if len(records) != 2:
        return record
    record.update({"tuning": [r["tuning"] for r in records], "counts": records[0]["counts"],
                   "wall_s": max(r["wall_s"] for r in records),
                   "evolution_s": [r["evolution_s"] for r in records],
                   "kernel_launches": [r["kernel_launches"] for r in records]})
    if records[0]["tuning"] is None or records[0]["tuning"] != records[1]["tuning"]:
        failures.append(f"mesh tune: the ranks tuned {record['tuning']}")
        return record
    rho0, rho1, _ = records[0]["tuning"]
    out = MESH_TUNE_ARGS[MESH_TUNE_ARGS.index("--output") + 1]
    name = "individual_0_tuned.txt" if rho1 <= rho0 else "individual_0_tune_rejected.txt"
    if not os.path.isfile(os.path.join(f"{out}_rank0", name)) or os.path.isdir(f"{out}_rank1"):
        failures.append(f"mesh tune: {name} not written by rank 0 alone")
    return record


def phase_mesh(failures: list, helmholtz_k80: dict) -> int:
    """The 511² V(2,2) on a device mesh against the same cycle unsharded;
    then FAS, Helmholtz, --multihost on the mesh and --tune on it.  Returns
    the kernel's launches on the mesh path, over all ranks of every run."""
    start = time.perf_counter()
    cards = torch.cuda.device_count()
    configs = _mesh_configs()
    record = {"phase": "mesh", "cards": cards, "runs": []}
    unsharded = None
    launches = 0
    for index, (backend, ranks) in enumerate(configs):
        t0 = time.perf_counter()
        rc, records, tail = _mesh_run(backend, ranks, compare=index == 0)
        run = {"backend": backend, "ranks": ranks, "rc": rc, "s": time.perf_counter() - t0}
        record["runs"].append(run)
        if rc != 0 or len(records) != ranks:
            failures.append(f"mesh: {backend} × {ranks} exited {rc} with {len(records)} "
                            f"records: {tail}")
            continue
        b = records[0]["B"]
        unsharded = records[0].get("unsharded", unsharded)
        run.update({k: b[k] for k in ("rho", "iterations", "ms_to_target", "wall_s", "route",
                                      "rows", "sharded_levels", "counts")})
        run["kernel_launches"] = [r["B"]["kernel_launches"] for r in records]
        run["residual0_A"] = records[0]["A"]["residuals"][0]
        launches += sum(run["kernel_launches"])
        if any(run["kernel_launches"]):
            failures.append(f"mesh: {backend} × {ranks} launched the kernel "
                            f"{run['kernel_launches']} times")
        if any((r["B"]["rho"], r["B"]["iterations"]) != (b["rho"], b["iterations"])
               for r in records):
            failures.append(f"mesh: the ranks of {backend} × {ranks} disagree")
        if unsharded is None:
            failures.append("mesh: no unsharded run to compare with")
            continue
        plain, default = unsharded["plain"], unsharded["default"]
        if not (abs(b["rho"] - plain["rho"]) <= 1e-5 * plain["rho"]
                and b["iterations"] == plain["iterations"]):
            failures.append(f"mesh: {backend} × {ranks} ρ {b['rho']} / {b['iterations']} vs "
                            f"unsharded plain {plain['rho']} / {plain['iterations']}")
        if not (abs(b["rho"] - default["rho"]) <= 0.02 * default["rho"]
                and abs(b["iterations"] - default["iterations"]) <= 1):
            failures.append(f"mesh: {backend} × {ranks} ρ {b['rho']} / {b['iterations']} vs "
                            f"unsharded default {default['rho']} / {default['iterations']}")
    record["unsharded"] = unsharded
    # The JAX package's CPU virtual-mesh run (a cross-check, not a target).
    record["reference_cpu_mesh"] = {"rho": 0.0612, "iterations": 10, "file": "MULTICHIP_r05.json"}
    record["poisson_s"] = time.perf_counter() - start

    # (c) and (d) run beside (a) and (b), whose times they slow: their
    # logbooks and ω are checked, not their times, and (a) and (b) judge ρ
    # and counts.
    t0 = time.perf_counter()
    multihost_procs = _start_optimize_ranks(4, MESH_MULTIHOST_ARGS)
    tune_procs = _start_optimize_ranks(2, MESH_TUNE_ARGS)
    record["fas"], fas_launches = mesh_fas(failures)
    record["fas"]["s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    helmholtz_runs, helmholtz_launches = mesh_helmholtz(failures, helmholtz_k80, configs)
    record["helmholtz"] = {"runs": helmholtz_runs, "unsharded": helmholtz_k80,
                           "s": time.perf_counter() - t1}
    multihost_records = _finish_optimize_ranks(failures, "mesh multihost", multihost_procs, t0)
    tune_records = _finish_optimize_ranks(failures, "mesh tune", tune_procs, t0)
    record["multihost"] = mesh_multihost(failures, multihost_records)
    record["tune"] = mesh_tune(failures, tune_records)
    record["optimize_s"] = time.perf_counter() - t0
    optimize_launches = sum(r["kernel_launches"] for r in multihost_records + tune_records)
    if optimize_launches:
        failures.append(f"mesh: the optimize runs launched the kernel {optimize_launches} times")
    launches += fas_launches + helmholtz_launches + optimize_launches
    record["mesh_launches"] = launches
    record["phase_s"] = time.perf_counter() - start
    emit(record)
    return launches


# (c) of the graphs phase, in a child process so that the failed capture
# leaves nothing behind in this one: the champion through a lowering whose
# operator reads one value to the host, eagerly (harmless) and on graphs
# (must raise CudaGraphError, never score); then a staged solver at 255²
# whose cycle reads one value to the host, eagerly (it solves) and on
# graphs (must raise CudaGraphError).  One JSON line.
_GRAPH_REFUSAL = """
import json, torch
from evostencils_torch import CudaGraphError
from evostencils_torch.backend import graphs
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.problems.poisson import poisson_2d
import chip_smoke

def reading(generator):
    apply = generator.lowering.system_apply
    def system_apply(operator, state):
        out = apply(operator, state)
        float(out[0].sum())  # a host read
        return out
    generator.lowering.system_apply = system_apply
    return generator

problem = poisson_2d(min_level=5, max_level=9, dtype=torch.float32)
champion = chip_smoke.load_champion(chip_smoke.bench_pset(problem))[0]
record = {}
for mode in (False, True):
    generator = reading(TorchProgramGenerator(
        problem, dtype=torch.float32, iteration_limit=500, device="cuda", cuda_graphs=mode))
    try:
        record[str(mode)] = {"returned": list(generator.generate_and_evaluate(
            champion, evaluation_samples=1))}
    except CudaGraphError as err:
        record[str(mode)] = {"raised": type(err).__name__, "message": str(err)[:400]}
record["counters"] = graphs.counters.as_dict()

class ReadingLowering(CycleLowering):
    def lower(self, expression):
        step = super().lower(expression)
        def reading(u, f):
            out = step(u, f)
            float(out[0].sum())  # a host read inside the cycle
            return out
        return reading

graphs.counters.reset()
problem = poisson_2d(min_level=4, max_level=8, dtype=torch.float32)
for mode in (False, True):
    try:
        solve, f32, f64_rhs, _ = chip_smoke._textbook_solver(
            problem, 2, 2, "cuda", fused=True, cuda_graphs=mode, lowering=ReadingLowering)
        record["staged_" + str(mode)] = {"returned": list(solve(f32, f64_rhs))}
    except CudaGraphError as err:
        record["staged_" + str(mode)] = {"raised": type(err).__name__,
                                         "message": str(err)[:400]}
record["staged_counters"] = graphs.counters.as_dict()
print(json.dumps(record), flush=True)
"""


def _same_fitness(graph: tuple, eager: tuple) -> bool:
    """ρ within 1e-6 relative (equal expected) and equal iterations; the
    same verdict on an infinite time."""
    (t_g, rho_g, it_g), (t_e, rho_e, it_e) = graph, eager
    return ((t_g >= 1e50) == (t_e >= 1e50) and it_g == it_e
            and (rho_g == rho_e or abs(rho_g - rho_e) <= 1e-6 * abs(rho_e)))


def phase_graphs(failures: list, graph_mode: dict, evolve: dict, helmholtz_k80: dict) -> None:
    """The main path, the evolution and the Helmholtz k = 80 rung on CUDA
    graphs (their own phases, the default) against the same runs with
    `cuda_graphs=False`; and the refusal of a body that reads to the host."""
    start = time.perf_counter()
    record = {"phase": "graphs"}
    # (a) The 16 bench trees and the champion at 511², the champion at 1023².
    eager = TorchProgramGenerator(
        poisson_2d(min_level=5, max_level=9, dtype=torch.float32), dtype=torch.float32,
        iteration_limit=500, device="cuda", cuda_graphs=False)
    eager_1023 = TorchProgramGenerator(
        poisson_2d(min_level=6, max_level=10, dtype=torch.float32), dtype=torch.float32,
        iteration_limit=500, device="cuda", cuda_graphs=False)
    rng = random.Random(20260816)
    pset = bench_pset(eager.problem)
    for _ in range(16):
        gp.gen_grow(pset, 2, 16, rng=rng)
    warm = gp.gen_grow(pset, 2, 10, rng=rng)
    eager.generate_and_evaluate(gp.compile_tree(warm, pset)[0], evaluation_samples=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, solves = [], []
    for expr in graph_mode["expressions"]:
        results.append(eager.generate_and_evaluate(expr, evaluation_samples=3))
        solves.append(eager.last_cycle_solve)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    champion = eager.generate_and_evaluate(graph_mode["champion"], evaluation_samples=3)
    champion_solve = eager.last_cycle_solve
    champion_1023 = eager_1023.generate_and_evaluate(
        graph_mode["champion_1023"], evaluation_samples=3)
    champion_1023_solve = eager_1023.last_cycle_solve
    pairs = list(zip(graph_mode["results"] + [graph_mode["champion_result"],
                                              graph_mode["champion_1023_result"]],
                     results + [champion, champion_1023],
                     graph_mode["solves"] + [graph_mode["champion_solve"],
                                             graph_mode["champion_1023_solve"]],
                     solves + [champion_solve, champion_1023_solve]))
    mismatches = [i for i, (g, e, gs, es) in enumerate(pairs)
                  if not _same_fitness(g, e) or gs != es]
    g_champ = graph_mode["champion_result"]
    record["bench"] = {
        "individuals": len(pairs), "mismatches": mismatches,
        "bitwise_equal_rho": sum(1 for g, e, _, _ in pairs if g[1] == e[1]),
        "stage_executed_equal": sum(1 for _, _, gs, es in pairs if gs == es),
        "evals_per_hour": {"graphs": graph_mode["evals_per_hour"],
                           "eager": len(results) / elapsed * 3600.0},
        "champion": {"graphs": list(g_champ), "eager": list(champion),
                     "ms_per_iteration": {"graphs": g_champ[0] / g_champ[2],
                                          "eager": champion[0] / champion[2]}},
        "champion_1023": {"graphs": list(graph_mode["champion_1023_result"]),
                          "eager": list(champion_1023)},
    }
    for i in mismatches:
        g, e, gs, es = pairs[i]
        failures.append(f"graphs: individual {i} on graphs {g} {gs}, eager {e} {es}")
    if not (abs(g_champ[1] / CHAMPION_RHO - 1.0) <= 1e-6 and g_champ[2] == 10):
        failures.append(f"graphs: the champion gives {g_champ[1:]} on graphs, "
                        f"not {CHAMPION_RHO} in 10")

    # The evolution on eager bodies, beside the evolve phase's on graphs
    # (NSGA-II's time objective differs between the two, so the
    # generations after the first may differ).
    original = TorchProgramGenerator.__init__

    def eager_init(self, *args, **kwargs):
        kwargs.setdefault("cuda_graphs", False)
        original(self, *args, **kwargs)

    TorchProgramGenerator.__init__ = eager_init
    try:
        run = torch_optimize.run(EVOLVE_EAGER_ARGS)
    finally:
        TorchProgramGenerator.__init__ = original
    evaluations = run.optimizer._total_number_of_evaluations
    record["evolve"] = {
        "graphs": {"evaluations": evolve["evaluations"], "evolution_s": evolve["evolution_s"],
                   "evals_per_hour": evolve["evals_per_hour"], **evolve["graphs"]},
        "eager": {"evaluations": evaluations, "evolution_s": run.evolution_s,
                  "evals_per_hour": evaluations / run.evolution_s * 3600.0},
    }
    del run

    # (b) Helmholtz k = 80, complex128, 127², cap 600.
    problem = helmholtz_2d(min_level=3, max_level=7, k=80.0)
    problem.outer_solver["max_iterations"] = LADDER_CAP
    helmholtz = TorchProgramGenerator(problem, dtype=torch.complex128, device="cuda",
                                      cuda_graphs=False)
    rung = rung_record(torch_evaluate_helmholtz_ladder.evaluate_ladder(
        helmholtz, "textbook V(2,1) ω=0.6 eager", textbook_v21(problem), 80.0, 1)[0])
    record["helmholtz_k80"] = {"graphs": helmholtz_k80, "eager": rung}
    g_it, e_it = helmholtz_k80["iterations"], rung["iterations"]
    if not ((helmholtz_k80["probe"], helmholtz_k80["stages"], helmholtz_k80["converged"])
            == (rung["probe"], rung["stages"], rung["converged"])
            and abs(g_it - e_it) <= 0.02 * e_it):
        failures.append(f"graphs: Helmholtz k = 80 on graphs {helmholtz_k80}, eager {rung}")

    # (c) No fallback.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _GRAPH_REFUSAL], capture_output=True,
                          text=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          timeout=600)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    refusal = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    record["refusal"] = {"record": refusal, "s": time.perf_counter() - t0}
    if refusal is None:
        failures.append(f"graphs: the refusal check exited {proc.returncode}: "
                        f"{(proc.stdout + proc.stderr)[-1500:]}")
    elif not (refusal["True"].get("raised") == "CudaGraphError"
              and "returned" in refusal["False"]
              and refusal["counters"]["capture_failures"] == 1
              and refusal["staged_True"].get("raised") == "CudaGraphError"
              and refusal["staged_False"].get("returned", [0, 1.0])[1] <= 1e-10
              and refusal["staged_counters"]["capture_failures"] == 1):
        failures.append(f"graphs: a body that reads to the host gave {refusal}")
    record["phase_s"] = time.perf_counter() - start
    emit(record)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    failures = []
    seconds = {}
    os.makedirs(os.path.dirname(RECORDS_FILE), exist_ok=True)
    open(RECORDS_FILE, "w").close()

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        try:
            return phase(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    device = timed("device", phase_device)
    kernel = timed("kernel", phase_kernel, failures)
    kernel_batched = timed("kernel_batched", phase_kernel_batched, failures)
    timed("stencil_kernel", phase_stencil_kernel, failures)
    timed("levels", phase_levels)
    launches_by_role, generator, champion, champion_rho, graph_mode = timed(
        "main_path", phase_main_path, failures)
    group_launches = timed("group", phase_group, failures)
    evolve_launches, evolve = timed("evolve", phase_evolve, failures)
    timed("profile", phase_profile, generator, champion)
    helmholtz_k80 = timed("helmholtz", phase_helmholtz, failures)
    timed("graphs", phase_graphs, failures, graph_mode, evolve, helmholtz_k80)
    replayed_by_role = graph_mode["replayed_by_role"]
    del graph_mode
    timed("helmholtz_c64", phase_helmholtz_c64, failures)
    cgs_launches = timed("krylov_cgs", phase_krylov_cgs, failures)
    timed("helmholtz_evolve", phase_helmholtz_evolve, failures)
    family_launches = {
        name: timed(name, phase, failures) for name, phase in (
            ("varcoeff", phase_varcoeff), ("poisson3d", phase_poisson3d),
            ("elasticity", phase_elasticity), ("fas", phase_fas),
            ("helmholtz_robin", phase_helmholtz_robin), ("fas_evolve", phase_fas_evolve))
    }
    timed("profile_families", phase_profile_families, failures)
    headline_launches = timed("headline", phase_headline, failures)
    timed("models", phase_models, failures, champion_rho)
    problem_file_launches = timed("problem_file", phase_problem_file, failures)
    family_launches["problem_file_fas"] = timed(
        "problem_file_fas", phase_problem_file_fas, failures)
    scripts_launches = timed("scripts", phase_scripts, failures)
    dispatch_launches = timed("dispatch", phase_dispatch, failures)
    mesh_launches = timed("mesh", phase_mesh, failures, helmholtz_k80)
    emit({"phase": "seconds", **seconds})
    if failures:
        for failure in failures:
            print(f"chip_smoke FAILED: {failure}", file=sys.stderr)
        return 1
    kernels = []
    for name, (replaces, timed) in ROLES.items():
        kernels.append({
            "name": f"rb_sweep_f32 ({name})", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "shape": list(timed),
            # Launches that reached the card on the main path, eager and
            # through CUDA-graph replays (the replayed part beside).
            "launches": launches_by_role[name],
            "replayed_launches": replayed_by_role[name],
            "evolve_launches": sum(n for shape, n in evolve_launches.items()
                                   if role(shape) == name and not batched(shape)),
            "krylov_cgs_launches": sum(n for shape, n in cgs_launches.items()
                                       if role(shape) == name),
            # The group phase's single launches: the members' timing solves.
            "group_launches": sum(n for shape, n in group_launches.items()
                                  if role(shape) == name and not batched(shape)),
            # The families the gate refuses: every count is checked to be 0.
            **{f"{phase}_launches": count for phase, count in family_launches.items()},
            "headline_launches": sum(n for shape, n in headline_launches.items()
                                     if role(shape) == name),
            **{f"{phase}_launches": sum(n for shape, n in by_shape.items()
                                        if role(shape) == name and not batched(shape))
               for phase, by_shape in (("problem_file", problem_file_launches),
                                       ("scripts", scripts_launches),
                                       ("dispatch", dispatch_launches))},
            # The mesh path runs the plain ops by policy: checked to be 0.
            "mesh_launches": mesh_launches,
            "max_abs_err": max(e for s in CHECKED if role(s) == name
                               for e in kernel[s]["max_abs_err"].values()),
            "ms": kernel[timed]["ms"], "plain_ms": kernel[timed]["plain_ms"],
            "bound_ms": kernel[timed]["bound_ms"], "bound_by": "bytes",
            "share_of_bound": kernel[timed]["share_of_bound"],
            # No single PyTorch call computes a red-black collective-Jacobi step.
            "library_ms": None,
        })
    for name, (replaces, timed) in ROLES.items():
        quoted = kernel_batched[(BATCH_QUOTED,) + timed]
        kernels.append({
            "name": f"rb_sweep_f32_batched ({name}, the group path's vmapped call)",
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "shape": [BATCH_QUOTED] + list(timed),
            # Batched launches in the group phase, eager and replayed, and
            # by member count.
            "launches": sum(n for shape, n in group_launches.items()
                            if batched(shape) and role(shape) == name),
            "launches_by_members": {
                str(members): sum(n for shape, n in group_launches.items()
                                  if batched(shape) and role(shape) == name
                                  and shape[0] == members)
                for members in BATCHES},
            "evolve_launches": sum(n for shape, n in evolve_launches.items()
                                   if role(shape) == name and batched(shape)),
            "max_abs_err": max(e for key, entry in kernel_batched.items() if role(key) == name
                               for e in entry["max_abs_err"].values()),
            "ms": quoted["ms"], "plain_ms": quoted["plain_ms"],
            "bound_ms": quoted["bound_ms"], "bound_by": "bytes",
            "share_of_bound": quoted["share_of_bound"],
            "ms_by_members": {str(key[0]): entry["ms"] for key, entry in kernel_batched.items()
                              if key[1:] == timed},
            # No single PyTorch call computes a batch of red-black steps.
            "library_ms": None,
        })
    emit({"phase": "end"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(device["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
