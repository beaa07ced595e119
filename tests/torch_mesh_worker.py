"""One rank of the port's mesh tests (tests/test_torch_mesh.py), run as

    python tests/torch_mesh_worker.py MODE RANK WORLD PORT OUTDIR

with PYTHONPATH set to the repository root, on a gloo process group over
127.0.0.1 whose collectives time out after 60 s.  It reads the inputs that
the test wrote to OUTDIR/inputs.npz and writes its results to
OUTDIR/<mode>_rank<RANK>.pkl (plain numpy and Python values), which the test
compares with the JAX package in its own process.  Modes:

  cycles   2D cycles (red-black V(2,2), block Jacobi of periods (2, 1),
           (3, 1), (2, 2)) through `sharded_step` on a (1, WORLD) mesh and
           unsharded; at world 2 also the 3D V(1,1) and the generator's
           fitness of four cycles and two families, sharded and not; at
           world 4 two cycles with every level split and
           `batched_sharded_evaluation` on a (2, 2) mesh; the slab
           converter's round trip.
  evolve   scripts/torch_optimize.run with --mesh 1,WORLD --cpu --seed 3.
  fake8    build_mesh(8) on a fake process group of 8 ranks in one process.

and for tests/test_torch_mesh_families.py:

  families (WORLD 2) complex halo exchanges, gathers and all-reduces
           against the whole grid; FAS (Newton and Picard V(2,2), its
           coarsest level split and held whole), Helmholtz (complex128
           V(2,1) and V(1,2), a staged run, an outer solve capped at 8
           iterations, complex64, Robin, the k-ladder), each through
           `TorchProgramGenerator(mesh=...)` on a (1, 2) mesh (the test
           evaluates them unsharded in its own process).
  multihost (WORLD 4) the complex collectives on a (1, 4) mesh; then on a
           (2, 2) mesh MultiHostDispatcher(mesh=...) over six ω variants of
           V(2,1), each rank re-evaluating the gathered list unsharded; then
           scripts/torch_optimize.run with --mesh 2,2 --multihost.
  tune     (WORLD 2) scripts/torch_optimize.run with --mesh 1,2 --tune.
"""

import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TIMEOUT = datetime.timedelta(seconds=60)
BLOCKS = {"b21": (2, 1), "b31": (3, 1), "b22": (2, 2)}


def replicate_below(world):
    """Rows below which a level is held whole: at world 2 levels 5 and 4
    (31², 15²) are split and level 3 (7², 4/3 rows) is gathered; at world 4
    levels 5 and 4 (8/8/8/7, 4/4/4/3 rows) are split and level 3 is
    gathered."""
    return 4 if world == 2 else 3


def cycle_2d(side, kind):
    if kind == "rb":
        return side.cycle(2, 2, 1.0, "collective")
    if kind == "cg":
        from evostencils_torch.ir import krylov

        return side.cycle(2, 2, 1.0, "collective",
                          coarse_solver=lambda op: krylov.generate_conjugate_gradient(op, 20))
    return side.cycle(2, 2, 0.8, BLOCKS[kind], red_black=False)


def run_cycles(rank, world, inputs):
    from evostencils_torch import interop
    from evostencils_torch.backend.evaluation import TorchProgramGenerator
    from evostencils_torch.backend.lowering import CycleLowering
    from evostencils_torch.ops import stencil_ops as sops
    from evostencils_torch.parallel.mesh import (
        batched_sharded_evaluation, build_mesh, sharded_step,
    )
    from evostencils_torch.problems import build_named_problem
    from evostencils_torch.problems.poisson import poisson_2d, poisson_3d
    from torch_parity import PORT, Side

    below = replicate_below(world)
    mesh = build_mesh(world, dp=1)
    out = {"mesh_shape": tuple(mesh.mesh.shape), "mesh_names": tuple(mesh.mesh_dim_names)}
    side = Side(PORT, poisson_2d(3, 5, dtype=torch.float64))
    u, f = (torch.from_numpy(inputs["u2"]),), (torch.from_numpy(inputs["f2"]),)
    for kind in ("rb", *BLOCKS):
        expression = cycle_2d(side, kind)
        lowering = CycleLowering(torch.float64, "cpu", mesh=mesh, replicate_below=below)
        out[f"{kind}_sharded"] = sharded_step(lowering.lower(expression), mesh, below)(u, f)[0].numpy()
        out[f"{kind}_plain"] = CycleLowering(torch.float64, "cpu").lower(expression)(u, f)[0].numpy()
        out[f"{kind}_counts"] = dict(lowering.layout.counts)
        out[f"{kind}_sharded_levels"] = [
            n for n in (31, 15, 7) if lowering.layout.slab((n, n)) is not None]
    out["rows_31"] = lowering.layout.bounds((31, 31))
    if world == 4:
        # Every level split (7² as 2/2/2/1 rows): the dense coarse solve
        # gathers its right-hand side, and a period-3 block reads two rows
        # across a one-row slab from two ranks.
        for kind in ("rb", "b31"):
            lowering = CycleLowering(torch.float64, "cpu", mesh=mesh, replicate_below=1)
            out[f"{kind}_all_split"] = sharded_step(
                lowering.lower(cycle_2d(side, kind)), mesh, 1)(u, f)[0].numpy()
            out[f"{kind}_all_split_counts"] = dict(lowering.layout.counts)

    # The JAX package's state, cut into this rank's rows and put back.
    state = (inputs["jax_u"], inputs["jax_f"])
    slabs = interop.state_to_slabs(state, lowering.layout, "cpu", torch.float64)
    out["converter_local_shapes"] = [tuple(x.shape) for x in slabs]
    back = interop.state_from_slabs(slabs, [x.shape for x in state], lowering.layout)
    out["converter_round_trip"] = all(np.array_equal(a, b) for a, b in zip(back, state))

    if world == 2:
        side3 = Side(PORT, poisson_3d(2, 4, dtype=torch.float64))
        expression = side3.cycle(1, 1, 1.0, "collective")
        u3, f3 = (torch.from_numpy(inputs["u3"]),), (torch.from_numpy(inputs["f3"]),)
        lowering = CycleLowering(torch.float64, "cpu", mesh=mesh, replicate_below=below)
        out["3d_sharded"] = sharded_step(lowering.lower(expression), mesh, below)(u3, f3)[0].numpy()
        out["3d_plain"] = CycleLowering(torch.float64, "cpu").lower(expression)(u3, f3)[0].numpy()
        out["3d_counts"] = dict(lowering.layout.counts)

    kinds = ("rb", "b21", "b31", "cg") if world == 2 else ("rb",)
    for kind in kinds:
        expression = cycle_2d(side, kind)
        for name, kwargs in (("sharded", dict(mesh=mesh, replicate_below=below)), ("plain", {})):
            generator = TorchProgramGenerator(side.problem, dtype=torch.float64, epsilon=1e-6,
                                              device="cpu", **kwargs)
            out[f"gen_{kind}_{name}"] = generator.generate_and_evaluate(
                expression, evaluation_samples=1)
            if name == "sharded":
                out[f"gen_{kind}_counts"] = dict(generator.layout.counts)
    if world == 2:
        for family, kind in (("poisson2d_var", "collective"), ("poisson2d_var", (2, 1)),
                             ("elasticity", "decoupled"), ("elasticity", (2, 1))):
            problem = build_named_problem(family, 3, 5)._clone(dtype=torch.float64)
            expression = Side(PORT, problem).cycle(
                2, 2, 0.8, kind, red_black=not isinstance(kind, tuple))
            for name, kwargs in (("sharded", dict(mesh=mesh, replicate_below=below)),
                                 ("plain", {})):
                generator = TorchProgramGenerator(problem, dtype=torch.float64, epsilon=1e-6,
                                                  device="cpu", **kwargs)
                out[f"family_{family}_{kind}_{name}"] = generator.generate_and_evaluate(
                    expression, evaluation_samples=1)

    if world == 4:
        batch_mesh = build_mesh(world)
        out["batch_mesh_shape"] = tuple(batch_mesh.mesh.shape)
        lowering = CycleLowering(torch.float64, "cpu", mesh=batch_mesh, replicate_below=below)
        step = lowering.lower(cycle_2d(side, "rb"))
        operator = side.problem.finest_operator()
        slab = lowering._slab(operator.grid[0])

        def residual_fn(u_, f_):
            return sops.l2_norm(sops.tree_sub(f_, lowering.system_apply(operator, u_)), slab)

        u_b = tuple(torch.stack([x] * 4) for x in u)
        f_b = tuple(torch.stack([x] * 4) for x in f)
        for n in (1, 2):
            run = batched_sharded_evaluation(step, batch_mesh, residual_fn, n_iterations=n)
            u_out, residuals = run(u_b, f_b)
            out[f"batch_residuals_{n}"] = residuals.numpy()
        out["batch_local_shape"] = tuple(u_out[0].shape)
        out["batch_slab"] = (slab.lo, slab.hi)
    return out


def run_evolve(rank, world, outdir):
    from scripts import torch_optimize

    run = torch_optimize.run([
        "--cpu", "--mesh", f"1,{world}", "--seed", "3", "--method", "nsga2",
        "--min-level", "3", "--max-level", "5", "--mu", "4", "--lambda", "4",
        "--generations", "2", "--population-initialization-factor", "2",
        "--evaluation-samples", "1", "--collective-timeout", "60",
        "--replicate-below", str(replicate_below(world)),
        "--output", os.path.join(outdir, f"evolve_output_rank{rank}"),
    ])
    return {
        "logbooks": [[{k: v for k, v in record.items() if k != "gen_s"}
                      for record in logbook.records] for logbook in run.logbooks],
        "halls_of_fame": [[(str(i), tuple(i.fitness_values)) for i in hof]
                          for hof in run.halls_of_fame],
        "best": run.best,
        "counts": dict(run.generator.layout.counts),
    }


def complex_collectives(mesh, inputs):
    """Halo exchanges of every reach up to 9 rows (beyond a neighbour's
    slab at world 4), gathers and all-reduced sums of complex fields on a
    slab, against the whole grid.  The values are whole numbers, so every
    sum is exact in any order."""
    from evostencils_torch.ops import stencil_ops as sops
    from evostencils_torch.parallel.mesh import MeshLayout, halo_exchange

    layout = MeshLayout(mesh, replicate_below=1)
    out = {}
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[-1]
        whole = torch.from_numpy(inputs["complex_field"]).to(dtype)
        other = torch.from_numpy(inputs["complex_other"]).to(dtype)
        slab = layout.slab(tuple(whole.shape))
        local, local_other = slab.cut(whole).clone(), slab.cut(other).clone()
        exact = True
        for reach in range(1, 10):
            padded = torch.cat([torch.zeros((reach, whole.shape[1]), dtype=dtype), whole,
                                torch.zeros((reach, whole.shape[1]), dtype=dtype)])
            got = halo_exchange(local, slab, reach)
            exact &= got.dtype == dtype and torch.equal(
                got, padded[slab.lo:slab.hi + 2 * reach])
        out[f"halo_{name}"] = exact
        out[f"gather_{name}"] = torch.equal(layout.gather(local, slab), whole)
        out[f"sum_{name}"] = (layout.all_reduce_sum(torch.sum(local)).item(),
                              torch.sum(whole).item())
        out[f"dot_{name}"] = (sops.dot((local,), (local_other,), slab).item(),
                              sops.dot((whole,), (other,)).item())
        out[f"norm_{name}"] = (sops.l2_norm((local,), slab).item(),
                               sops.l2_norm((whole,)).item())
    out["counts"] = dict(layout.counts)
    return out


def helmholtz_v_cycle(problem, pre, post, omega):
    from evostencils_torch.grammar.multigrid import generate_primitive_set
    from evostencils_torch.ir.reference_cycles import generate_v_cycle

    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level, maximum_local_system_size=8)
    return generate_v_cycle(terminals, problem.rhs(), pre_smoothing=pre,
                            post_smoothing=post, omega=omega)


HELMHOLTZ_TEXTBOOK = {"V21": (2, 1, 0.6), "V12": (1, 2, 0.7)}
HELMHOLTZ_CASES = {
    # name: (dtype, boundary, cycle, outer-solver spec)
    "V21": (torch.complex128, "dirichlet", "V21", {}),
    "V12": (torch.complex128, "dirichlet", "V12", {}),
    "staged": (torch.complex128, "dirichlet", "V21",
               {"probe_iterations": 8, "max_iterations": 500}),
    "c64": (torch.complex64, "dirichlet", "V21", {}),
    "robin": (torch.complex128, "robin", "V21", {}),
}


def fas_side():
    from evostencils_torch.problems import fas
    from torch_parity import PORT, Side

    return Side(PORT, fas.fas_2d(3, 5, dtype=torch.float64), depth=1,
                maximum_local_system_size=4)


def helmholtz_case(name):
    """(problem, dtype, textbook cycle) of one of HELMHOLTZ_CASES."""
    from evostencils_torch.problems import helmholtz

    dtype, boundary, cycle, spec = HELMHOLTZ_CASES[name]
    problem = helmholtz.helmholtz_2d(3, 5, k=20.0, boundary=boundary, dtype=dtype)
    problem.outer_solver.update(spec)
    return problem, dtype, helmholtz_v_cycle(problem, *HELMHOLTZ_TEXTBOOK[cycle])


def outer_tags(generator):
    """The outer-solve tags ("outer", "outer_probe_N") of the solver cache."""
    return sorted({part for key in generator._solver_cache for part in key
                   if isinstance(part, str) and part.startswith("outer")})


def evaluate_family(problem, dtype, expression, **generator_args):
    """A fitness through TorchProgramGenerator with what it did: the last
    outer solve, the outer-solve tags, the transfer counts and the sharded
    grid sizes."""
    from evostencils_torch.backend.evaluation import TorchProgramGenerator

    generator = TorchProgramGenerator(problem, dtype=dtype, device="cpu", **generator_args)
    fitness = generator.generate_and_evaluate(expression, evaluation_samples=1)
    layout = generator.layout
    return {
        "fitness": fitness, "outer": generator.last_outer_solve, "tags": outer_tags(generator),
        "counts": None if layout is None else dict(layout.counts),
        "sharded": None if layout is None else [
            n for n in (31, 15, 7) if layout.slab((n, n)) is not None],
    }


def capped_outer_solve(generator, iterations=8):
    """The V(2,1)-preconditioned outer BiCGStab capped at `iterations`, as
    (whole x, residual, initial residual, iterations)."""
    problem, _, expression = helmholtz_case("V21")
    vm, program = generator._vm_program(expression)
    operator = generator._outer_operator_for(expression)
    solve = generator._outer_solve_raw(vm.make_step(), operator, iterations)
    f = problem.initial_state(torch.complex128)[1]
    x, res, res0, executed = solve(generator._to_device(f), program)
    if generator.layout is not None:
        x = generator._to_host(x, operator.grid)
    return {"x": np.asarray(x[0]), "res": res, "res0": res0, "iterations": executed}


def run_families(rank, world, inputs):
    from evostencils_torch.backend.evaluation import TorchProgramGenerator
    from evostencils_torch.parallel.mesh import build_mesh

    mesh = build_mesh(world, dp=1)
    out = {"collectives": complex_collectives(mesh, inputs)}

    side = fas_side()
    for kind, below in FAS_CASES:
        out[f"fas_{kind}_{below}"] = evaluate_family(
            side.problem, torch.float64, side.cycle(2, 2, 0.8, kind, levels=1),
            mesh=mesh, replicate_below=below)
    for name in HELMHOLTZ_CASES:
        out[f"helmholtz_{name}"] = evaluate_family(
            *helmholtz_case(name), mesh=mesh, replicate_below=4)

    problem, dtype, expression = helmholtz_case("V21")
    generator = TorchProgramGenerator(problem, dtype=dtype, device="cpu", mesh=mesh,
                                      replicate_below=4)
    out["capped"] = capped_outer_solve(generator)
    generator = TorchProgramGenerator(problem, dtype=dtype, device="cpu", mesh=mesh,
                                      replicate_below=4, ladder_rungs=2)
    out["ladder"] = generator.generate_and_evaluate(
        expression, evaluation_samples=1, global_variable_values={"k": 20.0})
    out["ladder_k"] = generator.problem.parameters["k"]
    return out


# FAS's two-grid cycle (kind, replicate_below): its coarsest level (15²)
# split at 4 rows and held whole at 8.
FAS_CASES = (("newton", 4), ("newton", 8), ("picard", 4))


def run_multihost(rank, world, inputs, outdir):
    from evostencils_torch.backend.evaluation import TorchProgramGenerator
    from evostencils_torch.grammar.multigrid import generate_primitive_set
    from evostencils_torch.ir.reference_cycles import generate_v_cycle
    from evostencils_torch.parallel.dispatch import MultiHostDispatcher
    from evostencils_torch.parallel.mesh import build_mesh
    from evostencils_torch.problems.poisson import poisson_2d
    from scripts import torch_optimize

    out = {"collectives": complex_collectives(build_mesh(world, dp=1), inputs)}

    # dp over the mesh's rows (the dispatcher's round-robin), sp within a
    # row: tests/test_parallel.py's host-local mesh.
    mesh = build_mesh(world, dp=2)
    problem = poisson_2d(3, 5, dtype=torch.float64)
    _, terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors, 5,
        problem.equations, problem.operators, problem.fields, depth=2)
    expressions = [generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=w)
                   for w in MULTIHOST_OMEGAS]
    generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu", mesh=mesh,
                                      replicate_below=4)
    omega_of = {id(e): w for e, w in zip(expressions, MULTIHOST_OMEGAS)}
    evaluated = []

    def fitness(expression):
        evaluated.append(omega_of[id(expression)])
        return generator.generate_and_evaluate(expression, evaluation_samples=1)

    score_group = generator.layout.score_group
    dispatcher = MultiHostDispatcher(layout=generator.layout)
    out["dispatcher"] = (dispatcher.process_index, dispatcher.process_count,
                         type(dispatcher.inner).__name__)
    # Times over the mesh until the dispatcher splits the rows, then over sp.
    out["score_group"] = (score_group is None,
                          generator.layout.score_group is generator.layout.sp_group)
    # The gloo twins of the dp groups that an NCCL mesh gathers on.
    out["gloo_dp_group"] = dist.get_process_group_ranks(MultiHostDispatcher._gloo_dp_group(mesh))
    out["gathered"] = dispatcher.map(fitness, expressions)
    out["evaluated"] = evaluated
    out["sp_ranks"] = generator.layout.sp_ranks
    plain = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
    out["unsharded"] = [plain.generate_and_evaluate(e, evaluation_samples=1)
                        for e in expressions]

    run = torch_optimize.run([
        "--cpu", "--mesh", "2,2", "--multihost", "--seed", "3", "--method", "nsga2",
        "--min-level", "3", "--max-level", "5", "--mu", "4", "--lambda", "4",
        "--generations", "1", "--population-initialization-factor", "2",
        "--evaluation-samples", "1", "--collective-timeout", "60", "--replicate-below", "4",
        "--output", os.path.join(outdir, f"multihost_output_rank{rank}"),
    ])
    out["evolve"] = {
        "logbooks": [[{k: v for k, v in record.items() if k != "gen_s"}
                      for record in logbook.records] for logbook in run.logbooks],
        "halls_of_fame": [[(str(i), tuple(i.fitness_values)) for i in hof]
                          for hof in run.halls_of_fame],
        "evaluations": run.optimizer._total_number_of_evaluations,
        "score_group_is_sp": run.generator.layout.score_group is run.generator.layout.sp_group,
    }
    return out


# tests/test_parallel.py's six ω but the first: ω = 1.9 diverges, so row 0
# times two cycles and row 1 three, and a time reduced across the rows
# would wait for a call that never comes.
MULTIHOST_OMEGAS = (1.9, 0.8, 0.9, 1.0, 1.1, 1.2)


def run_tune(rank, world, outdir):
    from scripts import torch_optimize

    run = torch_optimize.run([
        "--cpu", "--mesh", f"1,{world}", "--seed", "3", "--tune", "--method", "nsga2",
        "--min-level", "3", "--max-level", "5", "--mu", "4", "--lambda", "4",
        "--generations", "1", "--population-initialization-factor", "2",
        "--evaluation-samples", "1", "--collective-timeout", "60",
        "--replicate-below", str(replicate_below(world)),
        "--output", os.path.join(outdir, f"tune_output_rank{rank}"),
    ])
    return {"best": run.best, "tuning": run.tuning,
            "counts": dict(run.generator.layout.counts)}


def run_fake8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from evostencils_torch.parallel.mesh import build_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = build_mesh(8)
    return {"shape": tuple(mesh.mesh.shape), "names": tuple(mesh.mesh_dim_names)}


def main():
    mode, rank, world, port, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if mode == "fake8":
        out = run_fake8()
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                          WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        if mode in ("cycles", "families", "multihost"):
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world, timeout=TIMEOUT)
            with np.load(os.path.join(outdir, "inputs.npz")) as data:
                inputs = dict(data)
            if mode == "cycles":
                out = run_cycles(rank, world, inputs)
            elif mode == "families":
                out = run_families(rank, world, inputs)
            else:
                out = run_multihost(rank, world, inputs, outdir)
        elif mode == "tune":
            out = run_tune(rank, world, outdir)
        else:
            out = run_evolve(rank, world, outdir)
    with open(os.path.join(outdir, f"{mode}_rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"MESH_WORKER_OK {mode} {rank}", flush=True)


if __name__ == "__main__":
    main()
