"""FAS, Helmholtz, complex dtypes, `--multihost` and `--tune` on the port's
device mesh (evostencils_torch/parallel/mesh.py), against the unsharded
port and the JAX package's mesh, on the CPU.

As tests/test_torch_mesh.py: one process per rank
(tests/torch_mesh_worker.py on gloo groups over 127.0.0.1, PYTHONPATH set
to this checkout, every collective bounded by 60 s), the unsharded port and
the JAX package on conftest's 8 virtual CPU devices (`build_mesh(8)`) in
this process meanwhile.  Levels 3-5 (31² finest); `replicate_below` 4, so
that 31² and 15² are split over two ranks and 7² is held whole.

* Complex halo exchanges, gathers and all-reduced sums, dots and norms of
  whole-numbered complex64 and complex128 fields: equal to the whole grid's,
  at 2 and 4 ranks.
* FAS (float64, the two-grid Newton and Picard V(2,2) ω 0.8 with 200 damped
  Picard sweeps on the coarsest level, which is split at `replicate_below`
  4 and held whole at 8): ρ within 1e-6 relative of the unsharded port and
  1e-5 of the JAX package's mesh run (whose own mesh moves its ρ by 4e-7),
  equal iterations.
* Helmholtz (k = 20, the V(2,1) ω 0.6 and V(1,2) ω 0.7 preconditioners of
  the outer BiCGStab, complex128; a staged run after an 8-iteration probe;
  complex64; Robin boundaries): the bands of tests/test_torch_helmholtz.py
  and their reason (counts ±2 and ρ within 10 % in complex128, 25 % and
  5 % in complex64), the same probe verdict and number of stages, and the
  same outer-solve builds.  An outer solve capped at 8 iterations, whose
  arithmetic is short: x within 1e-10 of the unsharded one.  The k-ladder
  (k = 20, 40) through `global_variable_values`.
* `MultiHostDispatcher(layout=...)` on a (2, 2) mesh, the counterpart of
  tests/test_parallel.py's host-local mesh: each dp row evaluates its half
  of six ω variants, and every rank's gathered list equals its unsharded
  re-evaluation within the reference's bounds (ρ 1e-4 relative, ±1
  iteration); `scripts/torch_optimize.py --mesh 2,2 --multihost` breeds the
  same populations on all four ranks.
* `scripts/torch_optimize.py --mesh 1,2 --tune`: both ranks take the same
  tuned ω, and rank 0 alone writes.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import reference_cycles as jax_cycles
from evostencils_tpu.parallel.mesh import build_mesh as jax_build_mesh
from evostencils_tpu.problems import fas as jax_fas
from evostencils_tpu.problems import helmholtz as jax_helmholtz
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.parallel.dispatch import ThreadPoolDispatcher
from test_torch_helmholtz import cache_tags, count_full_solves
from test_torch_mesh import _collect, _launch
from torch_mesh_worker import (
    FAS_CASES, HELMHOLTZ_CASES, HELMHOLTZ_TEXTBOOK, MULTIHOST_OMEGAS, capped_outer_solve,
    evaluate_family, fas_side, helmholtz_case,
)
from torch_parity import JAX, JAX_DTYPES, Side

INFINITY = 1e100
# tests/test_torch_helmholtz.py's bands.
COUNT_BAND, RHO_BAND = 2, 0.10
C64_COUNT_BAND, C64_RHO_BAND = 0.25, 0.05
LADDER_COUNT_BAND = 0.15
WORLDS = {"families": 2, "multihost": 4, "tune": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker group started at once; the unsharded port and the JAX
    package's mesh computed here meanwhile."""
    rng = np.random.default_rng(5)
    inputs = {
        "complex_field": rng.integers(-8, 9, (31, 31)) + 1j * rng.integers(-8, 9, (31, 31)),
        "complex_other": rng.integers(-8, 9, (31, 31)) + 1j * rng.integers(-8, 9, (31, 31)),
    }
    dirs, procs = {}, {}
    for mode, world in WORLDS.items():
        dirs[mode] = tmp_path_factory.mktemp(mode)
        np.savez(dirs[mode] / "inputs.npz", **inputs)
        procs[mode] = _launch(mode, world, dirs[mode])
    try:
        unsharded = _unsharded_port()
        reference = _jax_mesh()
    finally:
        results, errors = {}, []
        for mode in WORLDS:
            try:
                results[mode] = _collect(procs[mode], mode, dirs[mode])
            except AssertionError as error:
                errors.append(str(error))
        assert not errors, "\n".join(errors)
    return {"inputs": inputs, "plain": unsharded, "jax": reference, "dirs": dirs, **results}


def _unsharded_port():
    out = {}
    side = fas_side()
    for kind in ("newton", "picard"):
        out[f"fas_{kind}"] = evaluate_family(
            side.problem, torch.float64, side.cycle(2, 2, 0.8, kind, levels=1))
    for name in HELMHOLTZ_CASES:
        out[f"helmholtz_{name}"] = evaluate_family(*helmholtz_case(name))
    problem, dtype, expression = helmholtz_case("V21")
    out["capped"] = capped_outer_solve(TorchProgramGenerator(problem, dtype=dtype, device="cpu"))
    generator = TorchProgramGenerator(problem, dtype=dtype, device="cpu", ladder_rungs=2)
    out["ladder"] = generator.generate_and_evaluate(
        expression, evaluation_samples=1, global_variable_values={"k": 20.0})
    return out


def _jax_helmholtz(name):
    dtype, boundary, cycle, spec = HELMHOLTZ_CASES[name]
    problem = jax_helmholtz.helmholtz_2d(3, 5, k=20.0, boundary=boundary,
                                         dtype=JAX_DTYPES[dtype])
    problem.outer_solver.update(spec)
    _, terminals = jax_multigrid.generate_primitive_set(
        problem.approximation(), problem.rhs(), 2, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields,
        depth=problem.max_level - problem.min_level, maximum_local_system_size=8)
    pre, post, omega = HELMHOLTZ_TEXTBOOK[cycle]
    return problem, JAX_DTYPES[dtype], jax_cycles.generate_v_cycle(
        terminals, problem.rhs(), pre_smoothing=pre, post_smoothing=post, omega=omega)


def _jax_mesh():
    """The JAX package's generator on build_mesh(8), with the number of
    full outer solves it ran (its stages and one timing sample) and its
    outer-solve builds."""
    mesh = jax_build_mesh(8)
    out = {}
    side = Side(JAX, jax_fas.fas_2d(3, 5, dtype=jnp.float64), depth=1,
                maximum_local_system_size=4)
    generator = JaxProgramGenerator(side.problem, dtype=jnp.float64, mesh=mesh)
    with mesh:
        for kind in ("newton", "picard"):
            out[f"fas_{kind}"] = generator.generate_and_evaluate(
                side.cycle(2, 2, 0.8, kind, levels=1), evaluation_samples=1)
        for name in HELMHOLTZ_CASES:
            problem, dtype, expression = _jax_helmholtz(name)
            generator = JaxProgramGenerator(problem, dtype=dtype, mesh=mesh)
            solves = count_full_solves(generator)
            fitness = generator.generate_and_evaluate(expression, evaluation_samples=1)
            out[f"helmholtz_{name}"] = {"fitness": fitness, "full_solves": len(solves),
                                        "tags": cache_tags(generator)}
    return out


def _ranks_agree(results, key):
    """Every rank holds the same mesh result (times included: each is the
    largest over the ranks)."""
    for other in results[1:]:
        assert other[key]["fitness"] == results[0][key]["fitness"], key


def _within(value, expected, band):
    return abs(value - expected) <= band * abs(expected)


@pytest.mark.parametrize("mode", ["families", "multihost"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_complex_collectives_match_the_whole_grid(runs, mode, dtype):
    """2 ranks of 16/15 rows, 4 ranks of 8/8/8/7: reaches up to 9 rows
    take rows from two ranks."""
    for result in runs[mode]:
        c = result["collectives"]
        assert c[f"halo_{dtype}"] and c[f"gather_{dtype}"]
        for key in ("sum", "dot"):
            got, whole = c[f"{key}_{dtype}"]
            assert got == whole and isinstance(got, complex), (key, got, whole)
        got, whole = c[f"norm_{dtype}"]
        assert got == pytest.approx(whole, rel=1e-6 if dtype == "complex64" else 1e-14)
        assert c["counts"]["halo"] > 0 and c["counts"]["all_reduce"] > 0


@pytest.mark.parametrize("kind,below", FAS_CASES)
def test_fas_on_mesh_matches_unsharded_and_reference(runs, kind, below):
    key = f"fas_{kind}_{below}"
    _ranks_agree(runs["families"], key)
    _, rho_plain, it_plain = runs["plain"][f"fas_{kind}"]["fitness"]
    _, rho_ref, it_ref = runs["jax"][f"fas_{kind}"]
    for result in runs["families"]:
        t, rho, iterations = result[key]["fitness"]
        assert np.isfinite(t) and t < INFINITY and 0 < rho < 0.1
        assert _within(rho, rho_plain, 1e-6) and iterations == it_plain, (rho, rho_plain)
        assert _within(rho, rho_ref, 1e-5) and iterations == it_ref, (rho, rho_ref)
        # The coarsest level (15²) split at 4 rows, whole at 8.
        assert result[key]["sharded"] == ([31, 15] if below == 4 else [31])
        counts = result[key]["counts"]
        assert counts["halo"] > 0 and counts["all_reduce"] > 0
        assert ("gather" in counts) == (below == 8)


@pytest.mark.parametrize("name", list(HELMHOLTZ_CASES))
def test_helmholtz_on_mesh_matches_unsharded_and_reference(runs, name):
    key = f"helmholtz_{name}"
    _ranks_agree(runs["families"], key)
    plain = runs["plain"][key]
    reference = runs["jax"][key]
    count_band, rho_band = ((C64_COUNT_BAND, C64_RHO_BAND) if name == "c64"
                            else (COUNT_BAND, RHO_BAND))
    for result in runs["families"]:
        mesh = result[key]
        t, rho, iterations = mesh["fitness"]
        assert t < INFINITY and 0 < rho < 1
        assert mesh["sharded"] == [31, 15] and mesh["counts"]["host_gather"] > 0
        for other_t, other_rho, other_it in (plain["fitness"], reference["fitness"]):
            assert other_t < INFINITY
            band = count_band if name != "c64" else count_band * other_it
            assert abs(iterations - other_it) <= band, (name, iterations, other_it)
            assert _within(rho, other_rho, rho_band), (name, rho, other_rho)
        assert mesh["outer"]["probe"] == plain["outer"]["probe"] == "survived"
        assert mesh["outer"]["stages"] == plain["outer"]["stages"]
        # The reference's full solves: its stages and one timing sample.
        assert reference["full_solves"] == mesh["outer"]["stages"] + 1
        assert mesh["tags"] == plain["tags"] == reference["tags"]
    expected_stages = {"staged": 1, "c64": 1}.get(name, 0)
    assert runs["families"][0][key]["outer"]["stages"] == expected_stages


def test_capped_outer_solve_on_mesh_matches_unsharded(runs):
    """8 outer iterations: short arithmetic, so x and the residual agree to
    1e-10 although every inner product is summed per slab."""
    plain = runs["plain"]["capped"]
    for result in runs["families"]:
        mesh = result["capped"]
        assert mesh["iterations"] == plain["iterations"] == 8
        assert mesh["res0"] == pytest.approx(plain["res0"], rel=1e-14)
        assert abs(mesh["res"] - plain["res"]) <= 1e-10 * plain["res"]
        scale = np.abs(plain["x"]).max()
        assert mesh["x"].dtype == np.complex128
        assert np.abs(mesh["x"] - plain["x"]).max() <= 1e-10 * scale


def test_k_ladder_on_mesh_matches_unsharded(runs):
    """k = 20 and 40 through global_variable_values: the mean of the rungs;
    the base k is restored.  The k = 40 rung runs about 300 iterations,
    long enough for rounding to move its count by more than the short
    runs' ±2, so the mean count takes the 15 % of
    tests/test_torch_helmholtz.py's ladder (measured 163 vs 160)."""
    _, rho_plain, it_plain = runs["plain"]["ladder"]
    for result in runs["families"]:
        t, rho, iterations = result["ladder"]
        assert t < INFINITY and 0 < rho < 1
        assert _within(iterations, it_plain, LADDER_COUNT_BAND), (iterations, it_plain)
        assert _within(rho, rho_plain, RHO_BAND), (rho, rho_plain)
        assert result["ladder_k"] == 20.0
        assert result["ladder"] == runs["families"][0]["ladder"]


def test_multihost_dispatcher_on_mesh_matches_unsharded(runs):
    """(dp, sp) = (2, 2): row 0 (ranks 0, 1) evaluates ω 1.9, 0.9, 1.1 and
    row 1 (ranks 2, 3) ω 0.8, 1.0, 1.2, one at a time; every rank gathers
    all six, equal to its unsharded re-evaluation within the reference's
    bounds (tests/test_parallel.py:292-303).  ω = 1.9 diverges and is not
    timed, so the rows make different numbers of collective calls: times
    reduced across the rows would hang here."""
    results = runs["multihost"]
    for rank, result in enumerate(results):
        row = rank // 2
        assert result["dispatcher"] == (row, 2, "SerialDispatcher")
        assert result["score_group"] == (True, True)
        assert result["sp_ranks"] == [2 * row, 2 * row + 1]
        assert result["gloo_dp_group"] == [rank % 2, rank % 2 + 2]
        assert result["evaluated"] == list(MULTIHOST_OMEGAS[row::2])
        assert result["gathered"] == results[0]["gathered"]
        assert result["gathered"][0] == result["unsharded"][0] == (INFINITY,) * 3
        for fit, (_, rho_ref, it_ref) in zip(result["gathered"], result["unsharded"]):
            assert abs(fit[1] - rho_ref) <= 1e-4 * max(1.0, abs(rho_ref)), (fit, rho_ref)
            assert abs(int(fit[2]) - int(it_ref)) <= 1


def test_optimize_mesh_multihost_breeds_alike(runs):
    """scripts/torch_optimize.py --mesh 2,2 --multihost --cpu --seed 3:
    four identical logbooks and halls of fame, the rows' evaluations adding
    up to the run's, and only rank 0 writing."""
    results = [r["evolve"] for r in runs["multihost"]]
    for result in results:
        assert result["logbooks"] == results[0]["logbooks"]
        assert result["halls_of_fame"] == results[0]["halls_of_fame"]
        assert result["score_group_is_sp"]
    rows = [results[0]["evaluations"], results[2]["evaluations"]]
    assert results[1]["evaluations"] == rows[0] and results[3]["evaluations"] == rows[1]
    nevals = sum(record["nevals"] for logbook in results[0]["logbooks"] for record in logbook)
    assert min(rows) > 0 and sum(rows) <= nevals
    out = runs["dirs"]["multihost"]
    assert (out / "multihost_output_rank0" / "individual_0.txt").is_file()
    for rank in (1, 2, 3):
        assert not (out / f"multihost_output_rank{rank}").exists()


def test_optimize_mesh_tune_publishes_rank_0s_omegas(runs):
    """scripts/torch_optimize.py --mesh 1,2 --tune --cpu --seed 3: both
    ranks tune, take rank 0's ω, and measure the same ρ before and after on
    the mesh; rank 0 alone writes the tuned or the rejected file."""
    rank0, rank1 = runs["tune"]
    assert rank0["best"] == rank1["best"]
    assert rank0["tuning"] == rank1["tuning"]
    rho0, rho1, tuned = rank0["tuning"]
    assert tuned and all(0.1 <= w <= 1.9 for w in tuned)
    assert rank0["counts"]["broadcast"] == rank1["counts"]["broadcast"] == 1
    out = runs["dirs"]["tune"]
    written = {p.name for p in (out / "tune_output_rank0").iterdir()}
    assert ("individual_0_tuned.txt" in written) == (rho1 <= rho0)
    assert ("individual_0_tune_rejected.txt" in written) == (rho1 > rho0)
    assert not (out / "tune_output_rank1").exists()


@pytest.mark.parametrize("initialised", [True, False], ids=["cuda-initialised", "no-cuda"])
def test_thread_pool_workers_take_the_callers_card(monkeypatch, initialised):
    """ThreadPoolDispatcher's workers evaluate on the caller's card: the
    current card is CUDA's per-thread state, so a process given card 2
    (--multihost on a host with several) would otherwise evaluate on card
    0.  Before CUDA is initialised every thread starts on card 0, the
    caller's too, and the workers set nothing.  torch.cuda is patched: the
    test needs no card."""
    current = threading.local()
    calls = []

    def set_device(card):
        calls.append((threading.get_ident(), card))
        current.card = card

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: getattr(current, "card", 0))
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    caller_card = 2 if initialised else 0
    current.card = caller_card

    def work(item):
        return item, threading.get_ident(), torch.cuda.current_device()

    seen = ThreadPoolDispatcher(max_workers=3).map(work, list(range(6)))
    assert [item for item, _, _ in seen] == list(range(6))
    assert all(card == caller_card for _, _, card in seen)
    workers = {ident for _, ident, _ in seen}
    assert threading.get_ident() not in workers
    if initialised:
        assert all(card == 2 for _, card in calls)
        assert workers <= {ident for ident, _ in calls}
    else:
        assert calls == []
