#!/usr/bin/env python
"""Evolve multigrid solvers with the PyTorch/CUDA port (the counterpart of
scripts/optimize.py).

Runs genetic programming over the multigrid grammar for every problem
family of the reference (2D and 3D Poisson, variable-coefficient Poisson,
linear elasticity, 2D Helmholtz and the nonlinear FAS problem) through
evostencils_torch on the GPU, every fitness evaluation on the card (float32
2D Poisson with the hand-written red-black sweep kernel; Helmholtz in a
complex dtype, the evolved cycle preconditioning BiCGStab; FAS with the FAS
grammar), and writes the reference's artifacts:
`individual_j.txt` (hall of fame as grammar strings), `program.txt`,
`logbooks.p`, `populations.p` and, with --tune, `individual_0_tuned.txt` or
`individual_0_tune_rejected.txt`.  Checkpoints pickle evostencils_torch
classes: they resume here, not in scripts/optimize.py.

Examples:
  python3 scripts/torch_optimize.py --problem poisson2d --method nsga2 \\
      --mu 8 --lambda 8 --generations 50
  python3 scripts/torch_optimize.py --cpu --min-level 3 --max-level 5 \\
      --mu 4 --lambda 4 --generations 2 --dtype float64
  python3 scripts/torch_optimize.py --problem helmholtz --helmholtz-k0 20 \\
      --min-level 3 --max-level 5 --dtype complex128 --method sogp \\
      --ladder-rungs 1 --outer-cap 500 --mu 8 --lambda 8 --generations 10
  python3 scripts/torch_optimize.py --problem fas --method sogp --mu 4 \\
      --lambda 4 --generations 1 --tune

--tune runs the gradient ω tuner on every family, as the reference does.  Its
probe assumes a linear cycle: the reference records that it made its FAS
champion worse (VERDICT.md), and a tuned string whose ρ grew is written as
rejected.

--model-based scores individuals by the LFA ρ and the roofline model's
time per cycle (evostencils_torch/models/, H100 constants) instead of
running them, on hierarchies of at most two levels per run, as the
reference does; --tune is then skipped.

--problem-file loads an .exa2/.exa3/.exa4 spec (evostencils_torch/problems/
parser.py; examples under artifacts/problem_specs/) in place of a named
problem, with its levels from the .knowledge file beside it (or
--knowledge), which --min-level/--max-level override:
  python3 scripts/torch_optimize.py --problem-file \
      artifacts/problem_specs/2D_FD_Poisson_fromL2.exa2 --method nsga2 \
      --mu 16 --lambda 16 --generations 20 --evaluation-samples 3 --tune

--multihost splits each generation's evaluations across the processes that
torchrun starts (a gloo process group from torchrun's environment; every
process breeds the same populations from --seed and the gathered
fitnesses, and rank 0 writes the artifacts):
  torchrun --nproc_per_node 2 scripts/torch_optimize.py --multihost \
      --seed 3 --mu 8 --lambda 8 --generations 2

--mesh DP,SP evaluates every individual on a (dp, sp) device mesh of the
DP·SP processes torchrun starts (evostencils_torch/parallel/mesh.py): the
fine grids split by rows over sp, the same evaluation on every dp row, NCCL
with one card per process (gloo with --cpu, or with a gloo process group
the caller set up); every process breeds the same populations from
--seed and the largest measured time of all ranks, and rank 0 writes the
artifacts and checkpoints:
  torchrun --nproc_per_node 4 scripts/torch_optimize.py --mesh 2,2 \
      --seed 3 --mu 8 --lambda 8 --generations 1
With --multihost as well, the dp rows split each generation's evaluations
between them (the reference's production topology): the sp ranks of a row
evaluate the row's share together, each time is the largest within the
row, and the rows gather their fitnesses:
  torchrun --nproc_per_node 4 scripts/torch_optimize.py --mesh 2,2 \
      --multihost --seed 3 --mu 8 --lambda 8 --generations 1
Every problem, problem file and dtype runs under --mesh.  --tune under
--mesh tunes the whole grid on each process's own device, takes rank 0's
ω on every rank and measures the tuned cycle on the mesh.
--replicate-below sets the replication rule's rows (64, the reference's
default); --collective-timeout bounds every collective.

Without CUDA it stops unless --cpu is given.
"""

import argparse
import os
import random
import sys
import time
from typing import NamedTuple, Optional

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.backend.lowering import CycleLowering
from evostencils_torch.grammar import gp
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.problems import build_named_problem, load_problem_file
from evostencils_torch.problems.helmholtz import helmholtz_2d, helmholtz_ladder, max_level_for_k


class Run(NamedTuple):
    """What one run left behind, for callers in the same process."""

    optimizer: Optimizer
    generator: TorchProgramGenerator
    best: str
    halls_of_fame: list
    logbooks: list
    evolution_s: float
    # (ρ before, ρ after, tuned ω) of --tune, else None.
    tuning: Optional[tuple]


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--problem", default="poisson2d",
                        choices=["poisson2d", "poisson3d", "poisson2d_var",
                                 "elasticity", "helmholtz", "fas"])
    parser.add_argument("--method", default="nsga2",
                        choices=["nsga2", "nsga3", "sogp", "random"])
    parser.add_argument("--mu", type=int, default=8)
    parser.add_argument("--lambda", dest="lambda_", type=int, default=8)
    parser.add_argument("--generations", type=int, default=50)
    parser.add_argument("--generalization-interval", type=int, default=150)
    parser.add_argument("--min-level", type=int, default=None,
                        help="default 5 (helmholtz: 3; the reference's level "
                             "mapping of build_named_problem applies)")
    parser.add_argument("--max-level", type=int, default=None,
                        help="default 9 (helmholtz: the level with h·k ≈ 0.625)")
    parser.add_argument("--levels-per-run", type=int, default=None)
    parser.add_argument("--evaluation-samples", type=int, default=3)
    parser.add_argument("--population-initialization-factor", type=int, default=4,
                        help="the random initial population is this many times μ")
    parser.add_argument("--crossover-probability", type=float, default=0.7)
    parser.add_argument("--mutation-probability", type=float, default=0.3)
    parser.add_argument("--max-local-system-size", type=int, default=8)
    parser.add_argument("--model-based", action="store_true",
                        help="LFA + roofline fitness (≤2-level hierarchies per run)")
    parser.add_argument("--tune", action="store_true",
                        help="gradient-tune the best individual's relaxation "
                             "factors after evolution")
    parser.add_argument("--problem-file", default=None,
                        help="load an .exa2/.exa3/.exa4 spec instead of a "
                             "named problem")
    parser.add_argument("--knowledge", default=None,
                        help=".knowledge file for --problem-file (found "
                             "beside the spec when omitted)")
    parser.add_argument("--multihost", action="store_true",
                        help="split each generation's evaluations across the "
                             "processes torchrun starts (gloo process group "
                             "from its environment); needs --seed")
    parser.add_argument("--mesh", default=None, metavar="DP,SP",
                        help="evaluate on a (dp, sp) device mesh of the DP·SP "
                             "processes torchrun starts, fine grids split by "
                             "rows over sp (NCCL; gloo with --cpu); needs --seed")
    parser.add_argument("--replicate-below", type=int, default=64,
                        help="with --mesh, a level whose slabs would hold fewer "
                             "rows is held whole on every rank")
    parser.add_argument("--collective-timeout", type=float, default=300.0,
                        help="seconds any collective of --mesh may take before "
                             "the run fails")
    parser.add_argument("--seed-file", action="append", default=[],
                        help="file whose first non-comment line is a grammar "
                             "string seeded into the initial population "
                             "(repeatable)")
    parser.add_argument("--seed-textbook", action="append", default=[],
                        metavar="PRE,POST,OMEGA[,SMOOTHER]",
                        help="seed a textbook V(PRE,POST) cycle at relaxation "
                             "OMEGA into the initial population (repeatable); "
                             "an optional 4th field picks the smoother "
                             "production (collective_jacobi by default; "
                             "jacobi_picard or jacobi_newton for fas)")
    parser.add_argument("--continue-from-checkpoint", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output", default=None, help="result directory")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the GPU")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "float64", "complex64", "complex128"],
                        help="default: the problem's (float32; helmholtz complex64)")
    parser.add_argument("--helmholtz-k0", type=float, default=80.0,
                        help="base wavenumber for --problem helmholtz; the "
                             "generalization ramp doubles it per step with "
                             "h·k fixed")
    parser.add_argument("--outer-cap", type=int, default=None,
                        help="override the outer Krylov iteration cap during "
                             "evolution; validate champions at the full cap "
                             "with scripts/torch_evaluate_helmholtz_ladder.py")
    parser.add_argument("--ladder-rungs", type=int, default=3,
                        help="k-ladder rungs per Helmholtz fitness (3 = k, 2k, "
                             "4k); 1 during evolution keeps the selection "
                             "pressure on the base k")
    parser.add_argument("--no-outer", action="store_true",
                        help="strip the problem's outer Krylov solve and "
                             "evolve on the inner (preconditioner) system")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device: run on a GPU, or pass --cpu")
    if args.multihost and args.seed is None:
        parser.error("--multihost needs --seed: every process must breed the same populations")
    if args.mesh:
        if args.seed is None:
            parser.error("--mesh needs --seed: every process must breed the same populations")
        try:
            args.mesh = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            parser.error(f"--mesh takes DP,SP, not {args.mesh!r}")
        if len(args.mesh) != 2 or min(args.mesh) < 1:
            parser.error(f"--mesh takes DP,SP, not {args.mesh!r}")
    return args


def _build_problem(args):
    """The problem the flags describe (scripts/optimize.py:129-166)."""
    if args.problem_file:
        problem = load_problem_file(args.problem_file, args.knowledge)
        problem = problem.with_levels(
            args.min_level if args.min_level is not None else problem.min_level,
            args.max_level if args.max_level is not None else problem.max_level)
    elif args.problem == "helmholtz":
        max_level = (args.max_level if args.max_level is not None
                     else max_level_for_k(args.helmholtz_k0))
        problem = helmholtz_2d(
            min_level=args.min_level if args.min_level is not None else 3,
            max_level=max_level, k=args.helmholtz_k0)
    else:
        problem = build_named_problem(
            args.problem,
            args.min_level if args.min_level is not None else 5,
            args.max_level if args.max_level is not None else 9)
    if args.no_outer and problem.outer_solver:
        problem = problem._clone(outer_solver=None)
    elif args.outer_cap and problem.outer_solver:
        problem = problem._clone(
            outer_solver=dict(problem.outer_solver, max_iterations=args.outer_cap))
    if args.dtype:
        problem = problem._clone(dtype=getattr(torch, args.dtype))
    return problem


def _seed_individuals(args, problem):
    seeds = []
    for path in args.seed_file:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line and not line.startswith("#"):
                    seeds.append(line)
                    break
    if args.seed_textbook:
        from evostencils_torch.grammar.multigrid import (
            generate_primitive_set, textbook_cycle_string,
        )
        from evostencils_torch.utils.champions import omega_index

        fas = bool(problem.uses_fas)
        _, terminals = generate_primitive_set(
            problem.approximation(), problem.rhs(), problem.dimension,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields, depth=problem.max_level - problem.min_level,
            maximum_local_system_size=args.max_local_system_size, FAS=fas,
        )
        for spec in args.seed_textbook:
            parts = spec.split(",")
            pre, post, omega = int(parts[0]), int(parts[1]), float(parts[2])
            kwargs = {"smoother_name": parts[3]} if len(parts) > 3 else {}
            seeds.append(textbook_cycle_string(
                terminals, pre, post, omega_index=omega_index(omega), FAS=fas, **kwargs))
    return seeds


def _write_artifacts(output_dir, args, best, program, pops, logbooks, hofs):
    """The reference's durable artifacts (scripts/optimize.py:274-288):
    grammar strings are the re-evaluable representation."""
    for j, individual in enumerate(hofs[-1][: 2 * args.mu]):
        with open(os.path.join(output_dir, f"individual_{j}.txt"), "w") as f:
            f.write(str(individual) + "\n")
            f.write(f"# fitness: {individual.fitness_values}\n")
    with open(os.path.join(output_dir, "program.txt"), "w") as f:
        f.write(program)
    Optimizer.dump_data_structure(
        [lb.records for lb in logbooks], os.path.join(output_dir, "logbooks.p")
    )
    Optimizer.dump_data_structure(
        [[(str(i), i.fitness_values) for i in pop] for pop in pops],
        os.path.join(output_dir, "populations.p"),
    )


def _tune(output_dir, optimizer, generator, best):
    """Gradient-tune the best individual's ω (scripts/optimize.py:291-320);
    publish the tuned string only when ρ did not get worse (the tuner's
    probe is a linear error propagation, which a FAS cycle is not).  On a
    mesh every rank tunes the whole grid on its own device and takes rank
    0's ω, then the mesh measures ρ before and after; only the caller with
    an `output_dir` writes."""
    from evostencils_torch.optimization.relaxation import tune_relaxation_factors

    pset = optimizer._pset
    expr, _ = gp.compile_tree(gp.parse_tree(best, pset), pset)
    _, rho0, it0 = generator.generate_and_evaluate(expr, evaluation_samples=3)
    lowering = CycleLowering(generator.problem.dtype, generator.device, use_kernels=False)
    tuned, _ = tune_relaxation_factors(expr, generator.problem, lowering=lowering,
                                       layout=generator.layout)
    _, rho1, it1 = generator.generate_and_evaluate(expr, evaluation_samples=3)
    print(f"Gradient-tuned relaxation factors: rho {rho0:.4f} -> {rho1:.4f}, "
          f"iterations {it0} -> {it1}")
    if output_dir is None:
        return rho0, rho1, tuned
    if rho1 <= rho0:
        with open(os.path.join(output_dir, "individual_0_tuned.txt"), "w") as f:
            f.write(str(gp.parse_tree(best, pset)) + "\n")
            f.write(f"# tuned omegas: {[round(w, 4) for w in tuned]}\n")
            f.write(f"# rho: {rho0} -> {rho1}\n")
    else:
        print("Tuned omegas degraded the champion; keeping the untuned "
              "string (tuner probe assumes a linear cycle operator).")
        with open(os.path.join(output_dir, "individual_0_tune_rejected.txt"), "w") as f:
            f.write(f"# tuning REJECTED: rho {rho0} -> {rho1}\n")
            f.write(f"# rejected omegas: {[round(w, 4) for w in tuned]}\n")
    return rho0, rho1, tuned


def _multihost_dispatcher(cpu: bool, layout=None):
    """A MultiHostDispatcher over a gloo process group, initialised from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
    unless the caller initialised one; on a host with several cards each
    process takes the card of its LOCAL_RANK.  Given the `layout` of a
    generator on a mesh (whose group is initialised) it splits over the
    mesh's dp rows."""
    import torch.distributed as dist

    from evostencils_torch.parallel.dispatch import MultiHostDispatcher

    if layout is not None:
        return MultiHostDispatcher(layout=layout)
    if not dist.is_initialized():
        dist.init_process_group(backend="gloo")
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return MultiHostDispatcher()


def _device_mesh(args):
    """The (dp, sp) DeviceMesh of --mesh over a process group from
    torchrun's environment unless the caller initialised one: NCCL, one
    card per process; gloo with --cpu."""
    from evostencils_torch.parallel.mesh import build_mesh, init_from_env

    dp, sp = args.mesh
    init_from_env("gloo" if args.cpu else "nccl", args.collective_timeout, cpu=args.cpu)
    mesh = build_mesh(dp * sp, dp=dp)
    print(f"Evaluating on mesh {mesh}", flush=True)
    return mesh


def run(argv=None) -> Run:
    """Parse `argv`, evolve, write the artifacts and, with --tune, tune."""
    import torch.distributed as dist

    args = parse_arguments(argv)
    problem = _build_problem(args)
    output_dir = args.output or f"results_{problem.name}_torch"
    # The mesh first; a dispatcher on it splits over the dp rows of the
    # generator's layout.
    mesh = _device_mesh(args) if args.mesh else None
    dispatcher = _multihost_dispatcher(args.cpu) if args.multihost and mesh is None else None
    # Every process breeds the same populations; one writes them.
    rank = dist.get_rank() if args.multihost or mesh is not None else 0
    if rank == 0:
        os.makedirs(output_dir, exist_ok=True)

    generator = TorchProgramGenerator(
        problem, device="cpu" if args.cpu else "cuda", ladder_rungs=args.ladder_rungs,
        mesh=mesh, replicate_below=args.replicate_below)
    if args.multihost and mesh is not None:
        dispatcher = _multihost_dispatcher(args.cpu, generator.layout)
    convergence_evaluator = None
    performance_evaluator = None
    if args.model_based:
        from evostencils_torch.models.lfa import ConvergenceEvaluator
        from evostencils_torch.models.roofline import PerformanceEvaluator

        convergence_evaluator = ConvergenceEvaluator(
            problem.dimension, problem.coarsening_factors, problem.finest_grid)
        performance_evaluator = PerformanceEvaluator()
    optimizer = Optimizer.for_problem(
        problem,
        program_generator=generator,
        convergence_evaluator=convergence_evaluator,
        performance_evaluator=performance_evaluator,
        checkpoint_directory_path=os.path.join(output_dir, "checkpoints"),
        rng=random.Random(args.seed),
        dispatcher=dispatcher,
        write_checkpoints=rank == 0,
    )
    method = {
        "nsga2": optimizer.NSGAII,
        "nsga3": optimizer.NSGAIII,
        "sogp": optimizer.SOGP,
    }.get(args.method, optimizer.NSGAII)
    seed_individuals = _seed_individuals(args, problem)
    pde_parameter_values = {}
    if args.problem == "helmholtz":
        pde_parameter_values = {"k": [k for k, _ in helmholtz_ladder(4, k0=args.helmholtz_k0)]}

    start = time.perf_counter()
    best, program, pops, logbooks, hofs = optimizer.evolutionary_optimization(
        mu_=args.mu,
        lambda_=args.lambda_,
        population_initialization_factor=args.population_initialization_factor,
        generations=args.generations,
        generalization_interval=args.generalization_interval,
        crossover_probability=args.crossover_probability,
        mutation_probability=args.mutation_probability,
        optimization_method=method,
        use_random_search=args.method == "random",
        levels_per_run=args.levels_per_run,
        evaluation_samples=args.evaluation_samples,
        continue_from_checkpoint=args.continue_from_checkpoint,
        maximum_local_system_size=args.max_local_system_size,
        model_based_estimation=args.model_based,
        pde_parameter_values=pde_parameter_values,
        seed_individuals=seed_individuals or None,
        verbose=True,
    )
    evolution_s = time.perf_counter() - start
    print(f"Evaluations: {optimizer._total_number_of_evaluations} in "
          f"{evolution_s:.2f} s, {generator.group_members} of them in "
          f"{generator.groups} same-structure groups ({generator.groups_batched} batched, "
          f"{generator.group_s:.2f} s); cache hits "
          f"{optimizer._individual_cache_hits}")
    print(f"\nBest individual:\n{best}")
    tuning = None
    if rank == 0:
        _write_artifacts(output_dir, args, best, program, pops, logbooks, hofs)
    # On a mesh the measurements are collective: every rank tunes.
    if args.tune and not args.model_based and (rank == 0 or mesh is not None):
        tuning = _tune(output_dir if rank == 0 else None, optimizer, generator, best)
    if rank == 0:
        print(f"Results written to {output_dir}/")
    return Run(optimizer, generator, best, hofs, logbooks, evolution_s, tuning)


def main(argv=None) -> int:
    import torch.distributed as dist

    run(argv)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
