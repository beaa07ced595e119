"""The port and chip_smoke.py import without JAX.

The machine with the GPU has no JAX, so this is what breaks first there.
A fresh interpreter refuses every `jax`/`jaxlib` import, imports the port's
modules and chip_smoke (without running its main), and must end with no
jax module loaded.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "evostencils_torch",
    "evostencils_torch.problems",
    "evostencils_torch.problems.api",
    "evostencils_torch.problems.poisson",
    "evostencils_torch.ops.stencil_ops",
    "evostencils_torch.ops.intergrid",
    "evostencils_torch.ops.coarse_solve",
    "evostencils_torch.ops.smoothers",
    "evostencils_torch.ops.rb_sweep",
    "evostencils_torch.ops._build",
    "evostencils_torch.backend.lowering",
    "evostencils_torch.backend.vm",
    "evostencils_torch.backend.evaluation",
    "evostencils_torch.interop",
    "chip_smoke",
]

PROGRAM = f"""
import importlib, importlib.abc, sys

class RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{{name}} is refused: the port must not import JAX")
        return None

sys.meta_path.insert(0, RefuseJax())
for module in {MODULES!r}:
    importlib.import_module(module)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print("imported", len({MODULES!r}), "modules without jax")
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "without jax" in proc.stdout
