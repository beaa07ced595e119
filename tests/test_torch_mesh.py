"""The port's device mesh (evostencils_torch/parallel/mesh.py) against the
JAX package's, on the CPU.

The port runs one process per rank: tests/torch_mesh_worker.py on gloo
process groups of 2 and 4 ranks over 127.0.0.1 (PYTHONPATH set to this
checkout, every collective bounded by 60 s, every process by its own time
limit).  The workers write their results; this process compares them with
the JAX package run here on conftest's 8 virtual CPU devices.  2D Poisson
at levels 3-5 (31²) and 3D at levels 2-4 (15³), float64.  The replication
rule's threshold is lowered (4 rows at world 2, 3 at world 4) so that
levels 5 and 4 are split and level 3 is gathered: every cycle crosses the
gather boundary twice.  World 4 splits 31 rows 8/8/8/7.

* A cycle on the mesh against the same cycle unsharded in the port: max|Δ|
  ≤ 1e-14 (the ops add the same terms in the same order; only the block
  solve's batched matmul may block its sums another way), and against the
  JAX package's `shard_state`-wrapped step on build_mesh(8): ≤ 1e-12, the
  reference's own bound (tests/test_parallel.py).
* The generator's fitness (float64, residual target 1e-6 as in
  tests/test_torch_slice.py) on the mesh against
  `JaxProgramGenerator(mesh=build_mesh(8))` and against the unsharded port:
  ρ within 1e-6 relative, equal iterations.  The norms sum per slab, then
  over the slabs, so ρ may move in the last digits.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.backend.lowering import CycleLowering as JaxLowering
from evostencils_tpu.ir import krylov as jax_krylov
from evostencils_tpu.parallel.mesh import build_mesh as jax_build_mesh
from evostencils_tpu.parallel.mesh import shard_state as jax_shard_state
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_tpu.problems.poisson import poisson_3d as jax_poisson_3d
from evostencils_torch import NotPortedError
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ops import rb_sweep
from evostencils_torch.parallel.mesh import mesh_shape, row_split
from evostencils_torch.problems import build_named_problem
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.stencils import constant
from torch_parity import JAX, Side
from torch_mesh_worker import BLOCKS

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
PROCESS_TIMEOUT = 240
GENERATOR_KINDS = ("rb", "b21", "b31", "cg")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cycle(side, kind):
    """The worker's cycles, on the JAX package's side."""
    if kind == "rb":
        return side.cycle(2, 2, 1.0, "collective")
    if kind == "cg":
        return side.cycle(2, 2, 1.0, "collective",
                          coarse_solver=lambda op: jax_krylov.generate_conjugate_gradient(op, 20))
    return side.cycle(2, 2, 0.8, BLOCKS[kind], red_black=False)


def _launch(mode, world, outdir):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(rank), str(world), port, str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT))
        for rank in range(world if mode != "fake8" else 1)]


def _collect(procs, mode, outdir):
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=PROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"{mode} rank {rank} failed:\n{out[-4000:]}"
        with open(outdir / f"{mode}_rank{rank}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker group started at once; the JAX package's results
    computed here meanwhile."""
    rng = np.random.default_rng(11)
    jax_u, jax_f = jax_poisson_2d(3, 5, dtype=jnp.float64).initial_state(jnp.float64)
    inputs = {
        "u2": rng.standard_normal((31, 31)), "f2": rng.standard_normal((31, 31)),
        "u3": rng.standard_normal((15, 15, 15)), "f3": rng.standard_normal((15, 15, 15)),
        "jax_u": np.asarray(jax_u[0]), "jax_f": np.asarray(jax_f[0]),
    }
    dirs, procs = {}, {}
    for key, mode, world in (("w2", "cycles", 2), ("w4", "cycles", 4),
                             ("evolve", "evolve", 2), ("fake8", "fake8", 8)):
        dirs[key] = tmp_path_factory.mktemp(key)
        np.savez(dirs[key] / "inputs.npz", **inputs)
        procs[key] = _launch(mode, world, dirs[key])
    try:
        reference = _jax_reference(inputs)
    finally:
        results = {}
        errors = []
        for key, mode in (("w2", "cycles"), ("w4", "cycles"), ("evolve", "evolve"),
                          ("fake8", "fake8")):
            try:
                results[key] = _collect(procs[key], mode, dirs[key])
            except AssertionError as error:
                errors.append(str(error))
        assert not errors, "\n".join(errors)
    return {"inputs": inputs, "jax": reference, "dirs": dirs, **results}


def _jax_reference(inputs):
    mesh = jax_build_mesh(8)
    out = {}
    side = Side(JAX, jax_poisson_2d(3, 5, dtype=jnp.float64))
    lowering = JaxLowering(jnp.float64)

    def sharded(step, u, f):
        with mesh:
            return jax.jit(lambda u, f: step(jax_shard_state(u, mesh),
                                             jax_shard_state(f, mesh)))(u, f)[0]

    u2, f2 = (jnp.asarray(inputs["u2"]),), (jnp.asarray(inputs["f2"]),)
    for kind in ("rb", *BLOCKS):
        out[kind] = np.asarray(sharded(lowering.lower(_cycle(side, kind)), u2, f2))
    side3 = Side(JAX, jax_poisson_3d(2, 4, dtype=jnp.float64))
    out["3d"] = np.asarray(sharded(lowering.lower(side3.cycle(1, 1, 1.0, "collective")),
                                   (jnp.asarray(inputs["u3"]),), (jnp.asarray(inputs["f3"]),)))
    generator = JaxProgramGenerator(side.problem, dtype=jnp.float64, epsilon=1e-6, mesh=mesh)
    with mesh:
        for kind in GENERATOR_KINDS:
            out[f"gen_{kind}"] = generator.generate_and_evaluate(
                _cycle(side, kind), evaluation_samples=1)
    return out


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_mesh_shapes(runs):
    assert mesh_shape(8) == (2, 4)
    assert mesh_shape(4) == (2, 2) and mesh_shape(4, dp=1) == (1, 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_shape(8, dp=3)
    fake = runs["fake8"][0]
    assert fake == {"shape": (2, 4), "names": ("dp", "sp")}
    assert runs["w4"][0]["batch_mesh_shape"] == (2, 2)
    for key, world in (("w2", 2), ("w4", 4)):
        assert runs[key][0]["mesh_shape"] == (1, world)
        assert runs[key][0]["mesh_names"] == ("dp", "sp")
    assert [hi - lo for lo, hi in row_split(511, 4)] == [128, 128, 128, 127]
    assert [hi - lo for lo, hi in row_split(31, 4)] == [8, 8, 8, 7]
    assert runs["w4"][0]["rows_31"] == [(0, 8), (8, 16), (16, 24), (24, 31)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["rb", *BLOCKS])
def test_sharded_cycle_matches_single_device(runs, world, kind):
    """Red-black V(2,2) and block Jacobi of periods (2, 1) and (3, 1) (the
    matmul form, whose blocks straddle the uneven slabs' edges) and (2, 2)
    (the masked form)."""
    result = runs[f"w{world}"][0]
    assert result[f"{kind}_sharded_levels"] == [31, 15]
    assert result[f"{kind}_counts"]["gather"] > 0 and result[f"{kind}_counts"]["halo"] > 0
    assert _max_abs(result[f"{kind}_sharded"], result[f"{kind}_plain"]) <= 1e-14
    assert _max_abs(result[f"{kind}_sharded"], runs["jax"][kind]) <= 1e-12
    # Every rank gathered the same result.
    for other in runs[f"w{world}"][1:]:
        np.testing.assert_array_equal(other[f"{kind}_sharded"], result[f"{kind}_sharded"])


@pytest.mark.parametrize("kind", ["rb", "b31"])
def test_every_level_split_matches_single_device(runs, kind):
    """replicate_below = 1 at world 4: 7² is split 2/2/2/1, so the dense
    coarse solve gathers its right-hand side and a (3, 1) block takes its
    two halo rows from two ranks."""
    result = runs["w4"][0]
    expected = result[f"{kind}_plain"]
    assert _max_abs(result[f"{kind}_all_split"], expected) <= 1e-14
    assert result[f"{kind}_all_split_counts"]["gather"] > 0


def test_sharded_3d_cycle_matches_single_device(runs):
    """3D Poisson split along its leading axis, V(1,1)."""
    result = runs["w2"][0]
    assert result["3d_counts"]["halo"] > 0
    assert _max_abs(result["3d_sharded"], result["3d_plain"]) <= 1e-14
    assert _max_abs(result["3d_sharded"], runs["jax"]["3d"]) <= 1e-12


def test_batched_sharded_evaluation(runs):
    """(dp, sp) = (2, 2): each dp row advances its two of four identical
    instances, each split over sp; every rank ends with all four norms."""
    results = runs["w4"]
    for result in results:
        residuals = result["batch_residuals_2"]
        assert residuals.shape == (4,)
        np.testing.assert_allclose(residuals, residuals[0], rtol=1e-10)
        np.testing.assert_array_equal(residuals, results[0]["batch_residuals_2"])
        # Two cycles beat one.
        assert residuals[0] < result["batch_residuals_1"][0]
        assert result["batch_local_shape"][0] == 2
    assert sorted(r["batch_slab"] for r in results) == [(0, 16), (0, 16), (16, 31), (16, 31)]


def test_slab_converter_round_trips_the_reference_state(runs):
    for key, rows in (("w2", [16, 15]), ("w4", [8, 8, 8, 7])):
        for rank, result in enumerate(runs[key]):
            assert result["converter_round_trip"]
            assert result["converter_local_shapes"] == [(rows[rank], 31)] * 2


class TestMeshProductPath:
    """`TorchProgramGenerator(mesh=...)` and `scripts/torch_optimize.py
    --mesh`, as tests/test_parallel.py's class of the same name holds the
    JAX package's."""

    @pytest.mark.parametrize("kind", GENERATOR_KINDS)
    def test_generator_with_mesh_matches_unsharded_rho(self, runs, kind):
        t_ref, rho_ref, it_ref = runs["jax"][f"gen_{kind}"]
        for result in runs["w2"]:
            t, rho, iterations = result[f"gen_{kind}_sharded"]
            _, rho_plain, it_plain = result[f"gen_{kind}_plain"]
            assert np.isfinite(t) and t < 1e50
            assert abs(rho - rho_ref) <= 1e-6 * rho_ref and iterations == it_ref
            assert abs(rho - rho_plain) <= 1e-6 * rho_plain and iterations == it_plain
            # The measured time is the largest of both ranks: one fitness.
            assert t == runs["w2"][0][f"gen_{kind}_sharded"][0]
        assert runs["w2"][0][f"gen_{kind}_counts"]["all_reduce"] > 0
        if kind == "rb":
            for result in runs["w4"]:
                _, rho, iterations = result["gen_rb_sharded"]
                assert abs(rho - rho_ref) <= 1e-6 * rho_ref and iterations == it_ref

    @pytest.mark.parametrize("family,kind", [
        ("poisson2d_var", "collective"), ("poisson2d_var", (2, 1)),
        ("elasticity", "decoupled"), ("elasticity", (2, 1)),
    ])
    def test_family_on_mesh_matches_unsharded(self, runs, family, kind):
        """Variable coefficients (the planes cut to the slab) and the
        two-field elasticity system run on the mesh."""
        for result in runs["w2"]:
            _, rho, iterations = result[f"family_{family}_{kind}_sharded"]
            _, rho_plain, it_plain = result[f"family_{family}_{kind}_plain"]
            assert 0 < rho < 1
            assert abs(rho - rho_plain) <= 1e-6 * rho_plain and iterations == it_plain

    @pytest.mark.parametrize("family", ["fas", "helmholtz"])
    def test_unported_family_on_mesh_raises(self, family):
        """No unsharded run stands in for a family the mesh does not carry;
        the check comes before the mesh is used."""
        problem = build_named_problem(family, 3, 5)
        with pytest.raises(NotPortedError, match="mesh"):
            TorchProgramGenerator(problem, device="cpu", mesh=object())
        with pytest.raises(NotPortedError, match="mesh"):
            TorchProgramGenerator(poisson_2d(3, 5, dtype=torch.complex128), device="cpu",
                                  mesh=object())

    def test_mini_evolution_on_mesh(self, runs):
        """NSGA-II, μ = λ = 4, 2 generations through scripts/torch_optimize.py
        --mesh 1,2 --cpu --seed 3: both ranks breed the same populations, an
        individual converges, and rank 1 writes nothing."""
        rank0, rank1 = runs["evolve"]
        assert rank0["logbooks"] == rank1["logbooks"]
        assert rank0["halls_of_fame"] == rank1["halls_of_fame"]
        assert rank0["best"] == rank1["best"]
        fits = [f for hof in rank0["halls_of_fame"] for _, f in hof]
        assert any(f[0] < 1.0 for f in fits), "no converging individual evolved"
        assert rank0["counts"]["halo"] > 0 and rank0["counts"]["all_reduce"] > 0
        out = runs["dirs"]["evolve"]
        assert (out / "evolve_output_rank0" / "individual_0.txt").is_file()
        assert (out / "evolve_output_rank0" / "checkpoints" / "checkpoint.p").is_file()
        assert not (out / "evolve_output_rank1").exists()

    @pytest.mark.parametrize("argv,message", [
        (["--mesh", "1,2", "--multihost", "--seed", "3"], "--multihost"),
        (["--mesh", "1,2"], "--seed"),
        (["--mesh", "1,2", "--seed", "3", "--tune"], "--tune"),
        (["--mesh", "2", "--seed", "3"], "DP,SP"),
    ])
    def test_optimize_mesh_refusals(self, argv, message, capsys):
        from scripts import torch_optimize

        with pytest.raises(SystemExit) as exit_info:
            torch_optimize.parse_arguments(["--cpu", *argv])
        assert exit_info.value.code == 2
        assert message in capsys.readouterr().err


def test_sweep_kernel_gate_refuses_a_slab():
    """The mesh path launches the kernel 0 times by policy: the gate refuses
    any slab, as the reference turns its Pallas kernels off under a mesh."""
    stencil = constant.Stencil(
        (((0, 0), 4.0), ((1, 0), -1.0), ((-1, 0), -1.0), ((0, 1), -1.0), ((0, -1), -1.0)))
    assert rb_sweep.supports_rb_sweep((511, 511), stencil, torch.float32)
    assert not rb_sweep.supports_rb_sweep((128, 511), stencil, torch.float32, slab=object())
