"""Each cell through spbench.run's own path on the card, for a short
window: run on the chip with `python -m pytest spbench/tests -m cuda`."""

import time

import pytest

from spbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hpcg256.testcg", "laplace.spmv"])
def test_cell_on_card(card, workload):
    result, _ = harness.run_cell(workload, 2 ** 31 + 3, 2.0, True, time.perf_counter())
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
