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
)


def test_port_imports_no_jax():
    code = ("import pkgutil, sys, cusp_autotuned_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    __import__(m.name)\n"
            f"missing = [m for m in {SLICE_MODULES!r}\n"
            "           if 'cusp_autotuned_tpu_torch.' + m not in sys.modules]\n"
            "assert not missing, missing\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'cusp_autotuned_tpu', 'triton'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports, top level and inside its functions, name
    neither JAX nor the JAX package."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    bad = sorted(n for n in names if n.split(".")[0] in
                 ("jax", "jaxlib", "cusp_autotuned_tpu"))
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
