"""A whole run of each cell on the CPU at small grids, with the program as
it is and with a fault planted under the harness (spbench/control.py):
the program's run is correct, and the control (the reference in the
precision below the configuration's) and every fault the cell can have
come out not correct."""

import io
import time

import pytest

from spbench import control, harness
from spbench.tests.conftest import small_config

CELLS = [("hpcg256.testcg", "hpcg_testcg_256"), ("laplace.spmv", "cusp_laplacians")]


def run(workload, config, kind, seed=2 ** 31 + 11):
    with control.plant(kind, config):
        result, _ = harness.run_cell(workload, seed, 0.2, False, time.perf_counter(),
                                     device="cpu", config=config, log=io.StringIO())
    return result


@pytest.mark.parametrize("workload,config", CELLS)
def test_program_is_correct(workload, config):
    result = run(workload, small_config(config), "none")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind", ["control", "unchanged", "half", "altered"])
@pytest.mark.parametrize("workload,config", CELLS)
def test_plant_fails(workload, config, kind):
    result = run(workload, small_config(config), kind)
    assert not result["correct"] and result["failed"] > 0
