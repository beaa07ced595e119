"""Nothing the benchmark runs may load JAX or the JAX package, and the plain
reference takes nothing from the port.  Imports are compared by their
top-level name (the part before the first dot), as whole strings: the port's
name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PORTBENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "evostencils_tpu"}


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def python_files(directory):
    for base, _, files in os.walk(directory):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    offenders = {}
    for path in python_files(PORTBENCH):
        found = imported_top_levels(path) & FORBIDDEN
        if found:
            offenders[os.path.relpath(path, ROOT)] = sorted(found)
    assert not offenders


def test_the_reference_imports_nothing_of_the_port():
    offenders = {}
    for path in python_files(os.path.join(PORTBENCH, "reference")):
        found = {n for n in imported_top_levels(path)
                 if n in FORBIDDEN or n == "evostencils_torch"}
        if found:
            offenders[os.path.relpath(path, ROOT)] = sorted(found)
    assert not offenders


def test_the_top_level_names_are_compared_whole():
    assert "evostencils_torch" not in FORBIDDEN
    assert imported_top_levels(__file__) >= {"ast", "os", "subprocess", "sys", "pytest"}


@pytest.mark.parametrize("module", ["portbench.harness", "portbench.kinds.search",
                                    "portbench.kinds.solve", "portbench.kinds.outer"])
def test_loading_the_benchmark_loads_no_jax(module):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


METRICS = sorted(name[:-3] for name in os.listdir(os.path.join(PORTBENCH, "metrics"))
                 if name.endswith(".py"))


@pytest.mark.parametrize("metric", METRICS)
def test_loading_a_metric_reader_loads_no_jax(metric):
    """Each reader as the harness loads it, after the harness and every kind
    of work: what a run holds when it looks for forbidden modules."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import portbench.kinds.search, portbench.kinds.solve, portbench.kinds.outer; "
            "from portbench import harness; "
            f"read = harness.load_reader({metric!r}); assert callable(read); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_looks_for_forbidden_modules_after_the_readers():
    """The look comes after the last reader has run: a module that a reader
    loads is in sys.modules by then."""
    source = open(os.path.join(PORTBENCH, "harness.py")).read()
    body = source[source.index("def run("):]
    assert body.index("load_reader(") < body.index("forbidden_modules()")
    assert body.index("forbidden_modules()") > body.rindex("result[\"checks\"]")
