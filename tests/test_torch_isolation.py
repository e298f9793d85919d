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


def test_port_imports_no_jax():
    code = ("import pkgutil, sys, cusp_autotuned_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    __import__(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'cusp_autotuned_tpu', 'triton'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
