#!/usr/bin/env python
"""Executable tutorial: evolve a 2D Poisson multigrid solver end to end with
the PyTorch/CUDA port (the counterpart of docs/tutorial.py; the narrated
version of the same steps is docs/tutorial.md).

    python3 docs/torch_tutorial.py                     # on the card
    TUTORIAL_DEVICE=cpu python3 docs/torch_tutorial.py

It runs on the GPU unless TUTORIAL_DEVICE=cpu, and stops without a card
otherwise.  Other knobs: TUTORIAL_GENERATIONS (default 10), TUTORIAL_MU
(4).  At the demo scale (levels 3-5, μ = λ = 4, 10 generations) it takes a
few minutes on the CPU.
"""

import os
import random
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ── 1. Choose the device ──────────────────────────────────────────────
# The port runs on the card by default.  float64 lets the solver reach the
# reference's full 1e-12 residual target in one stage.
import torch

device = os.environ.get("TUTORIAL_DEVICE", "cuda")
if device != "cpu" and not torch.cuda.is_available():
    print("torch_tutorial: no CUDA device; set TUTORIAL_DEVICE=cpu to run on the CPU",
          file=sys.stderr)
    sys.exit(2)
dtype = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ── 2. Declare the problem ────────────────────────────────────────────
# A Problem bundles fields, operators (as stencil generators), equations
# and the level hierarchy.  It can be written in Python...
from evostencils_torch.problems.poisson import poisson_2d

hand_written = poisson_2d(min_level=3, max_level=5, dtype=dtype)

# ...or loaded from an ExaSlang-style spec, whose .knowledge file beside it
# gives the levels (5..9 = 511² here; the demo cuts them to 3..5, 31²).
from evostencils_torch.problems import load_problem_file

spec = os.path.join(ROOT, "artifacts", "problem_specs", "2D_FD_Poisson_fromL2.exa2")
problem = load_problem_file(spec, dtype=dtype)
print(f"loaded {os.path.basename(spec)}: fields {problem.field_names}, "
      f"levels {problem.min_level}..{problem.max_level}")
problem = problem.with_levels(3, 5)
grid = problem.grid_at(5)[0]
parsed_stencil = problem.operator_factories["Laplace"][0](5, {}).generate_stencil(grid)
assert parsed_stencil == hand_written.operator_factories["A"][0](5, {}).generate_stencil(grid)
print(f"problem: {problem.name}, levels {problem.min_level}..{problem.max_level}, "
      f"the same 5-point operator as poisson_2d")

# ── 3. Evaluate a textbook baseline cycle ─────────────────────────────
# The program generator lowers a cycle expression to torch operations on
# the device and measures (time to convergence, ρ, iterations).
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.reference_cycles import generate_v_cycle

generator = TorchProgramGenerator(problem, dtype=dtype, iteration_limit=100, device=device)
_, terminal_list = generate_primitive_set(
    problem.approximation(), problem.rhs(), problem.dimension,
    problem.coarsening_factors, problem.max_level, problem.equations,
    problem.operators, problem.fields,
    depth=problem.max_level - problem.min_level,
)
baseline = generate_v_cycle(terminal_list, problem.rhs(), pre_smoothing=2, post_smoothing=2)
t_ms, rho, iters = generator.generate_and_evaluate(baseline, evaluation_samples=1)
print(f"textbook V(2,2) on {device}: rho={rho:.4f}, {iters} iterations to 1e-12, "
      f"{t_ms:.2f} ms time to convergence")

# ── 4. Evolve solvers with grammar-guided genetic programming ─────────
# The optimizer owns the typed multigrid grammar, the (μ+λ) loop, the
# fitness cache, checkpoints and the halls of fame.
from evostencils_torch.optimization.optimizer import Optimizer

mu = int(os.environ.get("TUTORIAL_MU", 4))
generations = int(os.environ.get("TUTORIAL_GENERATIONS", 10))
with tempfile.TemporaryDirectory() as checkpoints:
    optimizer = Optimizer.for_problem(
        problem, program_generator=generator,
        checkpoint_directory_path=checkpoints,
        rng=random.Random(42),
    )
    best, program, pops, logbooks, hofs = optimizer.evolutionary_optimization(
        mu_=mu, lambda_=mu,
        population_initialization_factor=2,
        generations=generations,
        generalization_interval=10_000,      # no problem-size ramp at demo scale
        optimization_method=optimizer.SOGP,  # single-objective; NSGAII for (ρ, t)
        evaluation_samples=1,
        maximum_local_system_size=4,
        verbose=True,
    )
print(f"\nbest individual ({len(hofs[-1])} in hall of fame):\n{best[:120]}...")

# ── 5. Re-evaluate the champion from its grammar string ───────────────
# Tree strings are the durable artifact (individual_<j>.txt); they re-parse
# through the typed grammar.
t_ms, rho, iters = optimizer.generate_and_evaluate_program_from_grammar_representation(
    best, maximum_block_size=4, evaluation_samples=3
)
print(f"champion re-evaluated: rho={rho:.4f}, {iters} iterations")
if not rho < 1.0:
    raise SystemExit(f"the evolved champion does not converge (rho {rho})")

# ── 6. Gradient-tune the relaxation factors ───────────────────────────
# torch.autograd differentiates the measured log-contraction through the
# lowered cycle with respect to every ω in it; the lowering takes plain
# torch ops (use_kernels=False), since the CUDA kernel has no backward.
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import gp as gp_mod
from evostencils_torch.optimization.relaxation import tune_relaxation_factors

tree = gp_mod.parse_tree(best, optimizer._pset)
expression, _ = gp_mod.compile_tree(tree, optimizer._pset)
tuned, losses = tune_relaxation_factors(
    expression, problem, lowering=CycleLowering(dtype, device, use_kernels=False),
    iterations=30)
_, rho_tuned, _ = generator.generate_and_evaluate(expression, evaluation_samples=1)
print(f"after gradient ω-tuning: rho {rho:.4f} -> {rho_tuned:.4f}")

# ── 7. Where to go from here ─────────────────────────────────────────
# * scripts/torch_optimize.py            full CLI (NSGA-II, checkpoints, FAS,
#                                        Helmholtz k-ladder, --problem-file,
#                                        --multihost)
# * scripts/torch_headline_1024.py       1023² time to 1e-10
# * scripts/torch_evaluate_evolved_solver.py   re-run stored hall-of-fame trees
# * scripts/torch_champion_stats.py      n-sample statistics of champions
# * docs/tutorial.md                     the narrated version of these steps
print("\ntutorial complete")
