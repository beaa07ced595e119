"""The port and chip_smoke.py import without JAX and without the JAX package.

The machine with the GPU has no JAX, so this is what breaks first there;
and the port keeps its own copies of the reference's array-free layers,
so it must not reach into `evostencils_tpu` either, not even lazily.  A
fresh interpreter refuses every `jax`/`jaxlib`/`evostencils_tpu` import,
imports the port's modules (problems/parser.py and parallel/ among them),
scripts/torch_optimize.py, scripts/torch_evaluate_helmholtz_ladder.py,
scripts/torch_headline_1024.py, scripts/torch_calibrate_roofline.py,
scripts/torch_optimize_intergrid.py, the four champion scripts
(torch_evaluate_reference_solver, torch_evaluate_evolved_solver,
torch_champion_stats, torch_tune_champions), the mesh module
(parallel/mesh.py) and scripts/torch_mesh_dryrun.py, and chip_smoke
(without running its main), builds a grammar and compiles a tree through the port (which
runs the lazy imports inside the IR), builds, compiles and evaluates a
Helmholtz preconditioner (complex128, the outer BiCGStab solve), evaluates
a 3D, a variable-coefficient, a linear elasticity and a FAS cycle, loads
the four problem specs and runs the parsed FAS operator, evaluates a cycle
on a one-rank gloo mesh, runs the
evolution entry point on the CPU for one generation with --tune and the
tutorial docs/torch_tutorial.py on the CPU, and must end with none of them
loaded.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "evostencils_torch",
    "evostencils_torch.stencils",
    "evostencils_torch.stencils.constant",
    "evostencils_torch.stencils.periodic",
    "evostencils_torch.stencils.gallery",
    "evostencils_torch.ir",
    "evostencils_torch.ir.base",
    "evostencils_torch.ir.system",
    "evostencils_torch.ir.krylov",
    "evostencils_torch.ir.smoother",
    "evostencils_torch.ir.partitioning",
    "evostencils_torch.ir.transformations",
    "evostencils_torch.ir.reference_cycles",
    "evostencils_torch.grammar",
    "evostencils_torch.grammar.typing",
    "evostencils_torch.grammar.gp",
    "evostencils_torch.grammar.multigrid",
    "evostencils_torch.utils",
    "evostencils_torch.utils.champions",
    "evostencils_torch.utils.logbook",
    "evostencils_torch.problems",
    "evostencils_torch.problems.api",
    "evostencils_torch.problems.poisson",
    "evostencils_torch.problems.helmholtz",
    "evostencils_torch.problems.elasticity",
    "evostencils_torch.problems.fas",
    "evostencils_torch.problems.parser",
    "evostencils_torch.parallel",
    "evostencils_torch.parallel.dispatch",
    "evostencils_torch.parallel.mesh",
    "evostencils_torch.ops.stencil_ops",
    "evostencils_torch.ops.intergrid",
    "evostencils_torch.ops.coarse_solve",
    "evostencils_torch.ops.smoothers",
    "evostencils_torch.ops.krylov",
    "evostencils_torch.ops.rb_sweep",
    "evostencils_torch.ops._build",
    "evostencils_torch.backend.lowering",
    "evostencils_torch.backend.vm",
    "evostencils_torch.backend.evaluation",
    "evostencils_torch.interop",
    "evostencils_torch.measure",
    "evostencils_torch.optimization",
    "evostencils_torch.optimization.selection",
    "evostencils_torch.optimization.intergrid_transfer",
    "evostencils_torch.optimization.optimizer",
    "evostencils_torch.optimization.relaxation",
    "evostencils_torch.backend.device_solve",
    "evostencils_torch.models",
    "evostencils_torch.models.lfa",
    "evostencils_torch.models.roofline",
    "evostencils_torch.utils.timing",
    "evostencils_torch.utils.profiling",
    "evostencils_torch.utils.visualization",
    "scripts.torch_optimize",
    "scripts.torch_evaluate_helmholtz_ladder",
    "scripts.torch_headline_1024",
    "scripts.torch_calibrate_roofline",
    "scripts.torch_optimize_intergrid",
    "scripts.torch_evaluate_reference_solver",
    "scripts.torch_evaluate_evolved_solver",
    "scripts.torch_champion_stats",
    "scripts.torch_tune_champions",
    "scripts.torch_mesh_dryrun",
    "chip_smoke",
]

REFUSED = ("jax", "jaxlib", "evostencils_tpu")

PROGRAM = f"""
import importlib, importlib.abc, os, random, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {REFUSED!r}:
            raise ImportError(f"{{name}} is refused: the port must not import it")
        return None

sys.meta_path.insert(0, Refuse())
for module in {MODULES!r}:
    importlib.import_module(module)

import torch
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir import reference_cycles, transformations
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils.champions import apply_stored_omegas, parse_champion_file

problem = poisson_2d(3, 5, dtype=torch.float64)
pset, terminals = generate_primitive_set(
    problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
    problem.max_level, problem.equations, problem.operators, problem.fields,
    depth=2, maximum_local_system_size=4)
tree = gp.gen_grow(pset, 2, 8, rng=random.Random(1))
expr = gp.compile_tree(tree, pset)[0]
transformations.canonical_string(expr)
cycle = reference_cycles.generate_v_22_cycle_two_grid(terminals[0], problem.rhs())
TorchProgramGenerator(problem, dtype=torch.float64, device="cpu").generate_and_evaluate(
    cycle, evaluation_samples=1)
apply_stored_omegas(cycle, [1.0, 1.0, 1.0, 1.0], label="import test")

from evostencils_torch.problems import build_named_problem
helmholtz = build_named_problem("helmholtz").with_levels(3, 5).with_parameters({{"k": 20.0}})
pset, terminals = generate_primitive_set(
    helmholtz.approximation(), helmholtz.rhs(), helmholtz.dimension,
    helmholtz.coarsening_factors, helmholtz.max_level, helmholtz.equations,
    helmholtz.operators, helmholtz.fields, depth=2, maximum_local_system_size=4)
tree = gp.parse_tree(str(gp.gen_grow(pset, 2, 8, rng=random.Random(2))), pset)
generator = TorchProgramGenerator(
    helmholtz, dtype=torch.complex128, device="cpu", ladder_rungs=1)
generator.generate_and_evaluate(gp.compile_tree(tree, pset)[0], evaluation_samples=1)
t, rho, iterations = generator.generate_and_evaluate(
    reference_cycles.generate_v_cycle(terminals, helmholtz.rhs(), 2, 1, omega=0.6),
    evaluation_samples=1, global_variable_values={{"k": 20.0}})
assert t < 1e50 and rho < 1.0, (t, rho, iterations)
from evostencils_torch.problems import fas
for family in (build_named_problem("poisson3d", 4, 4), build_named_problem("poisson2d_var", 3, 4),
               build_named_problem("elasticity", 3, 4), fas.fas_2d(3, 4)):
    _, terminals = generate_primitive_set(
        family.approximation(), family.rhs(), family.dimension, family.coarsening_factors,
        family.max_level, family.equations, family.operators, family.fields,
        depth=family.max_level - family.min_level, maximum_local_system_size=4,
        FAS=family.uses_fas)
    if family.uses_fas:
        cycle = reference_cycles.generate_fas_v_22_cycle_two_grid(
            terminals[0], family.rhs(), omega=0.8)
    else:
        cycle = reference_cycles.generate_v_cycle(terminals, family.rhs(), 1, 1, omega=0.8)
    t, rho, iterations = TorchProgramGenerator(
        family, dtype=torch.float32, device="cpu").generate_and_evaluate(
            cycle, evaluation_samples=1)
    assert t < 1e50 and 0 < rho < 1.0, (family.name, t, rho, iterations)
from scripts import torch_optimize
output = sys.argv[1]
assert torch_optimize.main(["--cpu", "--min-level", "3", "--max-level", "5", "--mu", "4",
                            "--lambda", "4", "--generations", "1", "--evaluation-samples", "1",
                            "--seed", "1", "--tune", "--output", output]) == 0
assert os.path.isfile(os.path.join(output, "program.txt"))
from evostencils_torch.problems import load_problem_file
specs = os.path.join({ROOT!r}, "artifacts", "problem_specs")
for name in sorted(os.listdir(specs)):
    if not name.endswith(".knowledge"):
        parsed = load_problem_file(os.path.join(specs, name))
        assert parsed.rhs_functions is None or parsed.rhs_functions[0](
            *parsed.interior_coordinates(3)).shape == (7, 7), name
a = parsed.operator_factories["A"][0](3, parsed.parameters)
a.derivative_diag(torch.zeros(3)), a.nonlinear_term(torch.zeros(3))
import datetime, socket
import torch.distributed as dist
from evostencils_torch.parallel.mesh import build_mesh
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}", rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
_, terminals = generate_primitive_set(
    problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
    problem.max_level, problem.equations, problem.operators, problem.fields, depth=2)
t, rho, iterations = TorchProgramGenerator(
    problem, dtype=torch.float64, device="cpu", mesh=build_mesh(1)).generate_and_evaluate(
        reference_cycles.generate_v_cycle(terminals, problem.rhs()), evaluation_samples=1)
assert t < 1e50 and 0 < rho < 1.0, (t, rho, iterations)
dist.destroy_process_group()
import runpy
os.environ.update(TUTORIAL_DEVICE="cpu", TUTORIAL_GENERATIONS="1", TUTORIAL_MU="2")
runpy.run_path(os.path.join({ROOT!r}, "docs", "torch_tutorial.py"), run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {REFUSED!r})
assert not loaded, loaded
print("imported", len({MODULES!r}), "modules without jax or evostencils_tpu")
"""


def test_port_and_chip_smoke_import_without_jax_or_the_jax_package(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "without jax or evostencils_tpu" in proc.stdout


def test_evolution_entry_point_needs_the_card_or_cpu(monkeypatch, capsys):
    from scripts import torch_optimize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        torch_optimize.main(["--generations", "1"])
    assert exit_info.value.code != 0
    assert "--cpu" in capsys.readouterr().err
