"""Nothing the benchmark runs loads JAX or the JAX package, whose name the
port's begins with (top-level names compared whole), and the reference
imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from spbench.tests.conftest import ROOT, SPBENCH

BANNED = {"jax", "jaxlib", "flax", "cusp_autotuned_tpu"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(SPBENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, SPBENCH))
def test_no_jax_import(path):
    assert not {m.split(".")[0] for m in imports(path)} & BANNED


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, SPBENCH))
def test_reference_imports_no_program(path):
    found = {m.split(".")[0] for m in imports(path)}
    assert found <= {"__future__", "torch", "spbench"}, found
    assert all(m.startswith("spbench.reference") or not m.startswith("spbench")
               for m in imports(path))


def test_a_run_loads_no_jax():
    code = ("import time, sys; from spbench import harness; "
            "from spbench.tests.conftest import small_config; "
            "harness.run_cell('laplace.spmv', 5, 0.2, True, time.perf_counter(), "
            "device='cpu', config=small_config('cusp_laplacians'), log=open('/dev/null', 'w')); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))" % sorted(BANNED))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
