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
        if mode == "cycles":
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world, timeout=TIMEOUT)
            with np.load(os.path.join(outdir, "inputs.npz")) as data:
                inputs = dict(data)
            out = run_cycles(rank, world, inputs)
        else:
            out = run_evolve(rank, world, outdir)
    with open(os.path.join(outdir, f"{mode}_rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"MESH_WORKER_OK {mode} {rank}", flush=True)


if __name__ == "__main__":
    main()
