"""Tests of the benchmark's own code.  They run on the CPU at small grids;
the one marked `cuda` runs a cell on the card and skips without one,
deciding inside its fixture."""

import json
import os

import pytest

SPBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(SPBENCH)

# each configuration's matrices at a size a test can hold, in its order
SMALL_GRIDS = {
    "hpcg_testcg_256": [[12, 10, 8]],
    "cusp_laplacians": [[500], [20, 18], [8, 7, 6], [20, 18], [8, 7, 6]],
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


def load_config(name):
    with open(os.path.join(SPBENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def small_config(name):
    cfg = load_config(name)
    for spec, grid in zip(cfg["matrices"], SMALL_GRIDS[name]):
        spec["grid"] = grid
    return cfg


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")
