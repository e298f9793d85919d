"""The PyTorch port stands apart from JAX, and chip_smoke.py refuses to run
without a GPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


# modules of the port's slices, each of which the walk below must import
SLICE_MODULES = (
    "formats.ell", "formats.hyb", "gallery.generators", "gallery.random",
    "kernels.binned", "kernels.colsort", "kernels.pallas_spmv",
    "autotune.result", "autotune.search", "autotune.space", "autotune.tuner",
    "autotune.calibrate", "formats.dense", "eigen.arnoldi", "eigen.gram_schmidt",
    "eigen.lanczos", "eigen.lobpcg", "eigen.spectral_radius",
    "gallery.poisson", "gallery.suite", "kernels.colsort2", "kernels.routed",
    "autotune.cost_model", "autotune.fit_cost_model", "ops.format_utils",
    "relaxation.jacobi", "relaxation.polynomial", "precond.diagonal",
    "precond.smoothers", "precond.multilevel", "precond.aggregation",
    "precond.aggregation.strength", "precond.aggregation.aggregate",
    "precond.aggregation.tentative", "precond.aggregation.smooth",
    "precond.aggregation.structured_rap", "native",
    "kernels.streaming", "parallel", "parallel.sharded",
    "parallel.shard_map_spmv", "parallel.sharded_plans",
    "benchmarks", "benchmarks.harness", "benchmarks.bytes_per_spmv",
    "benchmarks.dia_probe", "benchmarks.dia_spmm_probe", "benchmarks.routed_probe",
    "utils.profiling", "bench", "ops.transpose", "solvers.cr",
    "solvers.bicgstab", "solvers.bicg", "solvers.gmres", "solvers.cg_m",
    "solvers.bicgstab_m", "solvers.mixed", "formats.permutation",
    "ops.segment", "graph", "graph.traversal", "graph.mis", "graph.coloring",
    "graph.ordering", "graph.hilbert", "relaxation.gauss_seidel",
    "relaxation.sor", "precond.ainv",
    "ops.spgemm", "ops.elementwise", "ops.sort", "ops.lapack", "ops.verify",
    "ops.printing", "ops.functional", "ops.iterator_utils", "gallery.grid",
    "gallery.diffusion", "io", "io.matrix_market", "io.binary", "io.dimacs",
    "utils.trace", "benchmarks.spgemm_compress",
    "utils.device_time", "backend.tsparse", "autotune.__main__", "examples",
    *(f"examples.{name}" for name in (
        "01_formats_and_convert", "02_solve_poisson", "03_amg_preconditioner",
        "04_autotuned_spmv", "05_graph_and_io", "06_multichip",
        "07_spmv_strategies", "08_large_operators",
        "09_matrix_free_and_assembly")),
)
# the JAX side: JAX itself, the JAX package, and the JAX repository's
# bench.py and benchmarks/ folder
JAX_SIDE = ("jax", "jaxlib", "cusp_autotuned_tpu", "bench", "benchmarks")


def test_port_imports_no_jax():
    code = ("import pkgutil, sys, cusp_autotuned_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    __import__(m.name)\n"
            f"missing = [m for m in {SLICE_MODULES!r}\n"
            "           if 'cusp_autotuned_tpu_torch.' + m not in sys.modules]\n"
            "assert not missing, missing\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{JAX_SIDE + ('triton',)!r})\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_jax_module_has_a_twin():
    """Each module of the JAX package has one of the same path in the port,
    or of its new name: kernels/pallas_X.py may be kernels/X.py, and the
    vendor baseline backend/jsparse.py is backend/tsparse.py."""
    def modules(package):
        root = os.path.join(REPO, package)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, dirs, files in os.walk(root)
                if "_build" not in os.path.relpath(d, root).split(os.sep)
                for f in files if f.endswith(".py")}
    renames = {"backend/jsparse.py": "backend/tsparse.py"}
    port = modules("cusp_autotuned_tpu_torch")
    missing = sorted(m for m in modules("cusp_autotuned_tpu") if m not in port
                     and renames.get(m, m.replace("kernels/pallas_", "kernels/"))
                     not in port)
    assert not missing, missing


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports, top level and inside its functions, name
    neither JAX nor the JAX package, bench.py or benchmarks/."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in JAX_SIDE)
    assert not bad, bad
    assert "cusp_autotuned_tpu_torch.autotune" in names


def test_every_kernel_source_is_registered():
    """Each CUDA source of the port exports the symbols the loader binds."""
    from cusp_autotuned_tpu_torch.kernels import _build
    exported = ""
    for name in os.listdir(_build.CSRC):
        if name.endswith(".cu"):
            with open(os.path.join(_build.CSRC, name)) as f:
                exported += f.read()
    for stem, (_, suffixes) in _build._SIGNATURES.items():
        for suffix in suffixes:
            assert f"int {stem}_{suffix}(" in exported, f"{stem}_{suffix}"


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
