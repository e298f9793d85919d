"""The port's bench (cusp_autotuned_tpu_torch/bench.py) against the JAX
repository's bench.py on the CPU: each row's useful bytes or flops equal
bench.py's formulas (:76, :90-91, :102, :115, :131, :149-150, :156-157,
:177-178, :194-196, :412) on the same matrices at a small scale, and the
metric and sweep keys are bench.py's.  The bench itself times the card
and refuses the CPU (tests/test_torch_harness.py)."""

import os
import re

import numpy as np
import pytest

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.gallery.suite import _powerlaw, _scattered

from cusp_autotuned_tpu_torch import bench, gallery

from tests.torch_parity import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.05


def _jax_counts(scale):
    """bench.py's numerators, transcribed, on its matrices at `scale`."""
    g9, g5 = int(333 * scale), int(300 * scale)
    A = jgallery.poisson9pt(g9, g9, format="csr", dtype=np.float32)
    S = _powerlaw(int(100_000 * scale), int(1_000_000 * scale), a=1.7, seed=0)
    D = jgallery.poisson5pt(g5, g5, format="dia", dtype=np.float32)
    Ss = _scattered(int(120_000 * scale), 6, seed=8)
    return {
        "csr_binned_p9_1m_gbps": A.nnz * 8 + A.num_rows * 8,
        "csr_colsort_powerlaw_1m_gbps": S.nnz * 8 + S.shape[0] * 8,
        "dia_spmm_k128_gflops": 2 * D.nnz * 128,
        "spmm_p9_k16_via_dia_gflops": 2 * A.nnz * 16,
        "colsort_spmm_scattered_k16_gflops": 2 * Ss.nnz * 16,
        "csr_colsort2_powerlaw_1m_gbps": S.nnz * 8 + S.shape[0] * 8,
        "colsort2_spmm_scattered_k16_gflops": 2 * Ss.nnz * 16,
        "routed_spmv_scattered_gbps": Ss.nnz * 8 + Ss.shape[0] * 8,
    }


@pytest.fixture(scope="module")
def counts():
    mats = bench.workloads("cpu", SCALE)
    port = {key: bench.row_numerator(key, mats[name], k)
            for key, name, _, k, _, _ in bench.RATE_ROWS}
    return port, _jax_counts(SCALE)


@pytest.mark.parametrize("key", [r[0] for r in bench.RATE_ROWS])
def test_rate_row_counts_are_bench_pys(key, counts):
    port, jax_side = counts
    assert port[key] == jax_side[key] > 0


@pytest.mark.parametrize("grid", [30, 47])
def test_dia_useful_bytes_are_bench_pys(grid):
    """The headline's and the bf16 row's bytes: (k rows_padded + 2 n) 4."""
    J = jgallery.poisson5pt(grid, grid, format="dia", dtype=np.float32)
    A = gallery.poisson5pt(grid, grid, format="dia", device="cpu")
    assert A.rows_padded == J.rows_padded
    assert bench.dia_bytes(A) == (J.num_diagonals * J.rows_padded
                                  + 2 * J.num_rows) * 4


def _bench_py():
    with open(os.path.join(REPO, "bench.py")) as f:
        return f.read()


def test_metric_is_bench_pys():
    src = _bench_py()
    assert '"metric": f"SpMV DIA poisson5pt({grid}x{grid}) marginal "' in src
    assert 'f"bandwidth (stream baseline {stream_gbps:.0f} GB/s)"' in src
    assert bench.metric(1000, 3070.4) == \
        "SpMV DIA poisson5pt(1000x1000) marginal bandwidth (stream baseline 3070 GB/s)"
    assert "SpMV DIA poisson5pt(1000x1000)" in bench.metric(bench.GRID, 1.0)


def test_sweep_keys_are_bench_pys():
    """Every key of the port's sweep is one that bench.py writes (a rate
    key with its "_marg" twin, which put_rate adds, :61-69), except
    launch_host_us, which takes the place of dispatch_fixed_ms."""
    src = _bench_py()
    written = set(re.findall(r'(?:out|sweep)\["(\w+)"\]', src))
    rates = set(re.findall(r'put_rate\("(\w+)"', src))
    known = written | rates | {k + "_marg" for k in rates}
    assert set(bench.SWEEP_KEYS) - known == set(bench.NEW_KEYS) == {"launch_host_us"}
    assert "dispatch_fixed_ms" in written
    assert set(bench.SOLVE_KEYS) >= {"cgcu_1m_iters", "cgcu_1m_ms_per_iter",
                                     "amg_cg_iters", "amg_setup_1m_warm_s"}
    assert rates == {r[0] for r in bench.RATE_ROWS} | {"dia_bf16_spmv_gbps_f32equiv"}
    # the irreplaceable rows come first
    assert bench.SWEEP_KEYS[:4] == ("cgcu_impl", "cgcu_1m_iters", "cgcu_1m_s",
                                    "cgcu_1m_ms_per_iter")


def test_working_bytes_count_what_a_call_moves():
    """bench.working_bytes, the set time_cold keeps out of L2: the
    headline's dia_bytes in f32, half the diagonals' bytes in bf16, and
    x and y k times over for a block of k columns."""
    import torch
    A = gallery.poisson5pt(30, 30, format="dia", device="cpu")
    x, X = torch.ones(A.num_cols), torch.ones(A.num_cols, 16)
    vectors = (A.num_rows + A.num_cols) * 4
    assert bench.working_bytes(A, {"impl": "cuda"}, x) == bench.dia_bytes(A)
    assert bench.working_bytes(A, {"impl": "cuda", "value_dtype": "bfloat16"}, x) \
        == A.data.numel() * 2 + vectors
    assert bench.working_bytes(A, {"impl": "cuda"}, X) \
        == A.data.numel() * 4 + 16 * vectors
