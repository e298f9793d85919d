"""The port's binned and colsort rails against the JAX package's Pallas
build functions, on the CPU.

On the CPU each wrapper takes its kernel's plain PyTorch version (the row
bins walked one by one for `binned`, a gather and an index_add_ for
`colsort`), held here against the JAX build functions run in interpret
mode on the shapes of tests/test_pallas.py, at that file's tolerance (rtol
1e-4, atol 1e-4).  So this checks the plans and the bookkeeping; the CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_binned import build_binned as jax_binned
from cusp_autotuned_tpu.kernels.pallas_colsort import build_colsort as jax_colsort

from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.kernels import build_spmv
from cusp_autotuned_tpu_torch.kernels.binned import (
    GROUPS, binned_spmv, build_binned, plan_bins,
)
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort, coo_spmv
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

from tests.torch_parity import one_thread, port_of  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_pallas.py:161


def _powerlaw(n, nnz, seed=0):
    """tests/test_pallas.py:164-172: Zipf row lengths, random columns."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.7, n).astype(np.int64), n // 2)
    deg = np.maximum(deg * nnz // max(1, deg.sum()), 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    return sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(n, n)).tocsr()


def _tridiagonal(n=500):
    return sp.diags([np.ones(n - 1), 2 * np.ones(n), 3 * np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


# name -> (scipy matrix, format, JAX plan config), as tests/test_pallas.py
CASES = {
    "poisson9": (lambda: jgallery.poisson9pt(35, 35, format="csr").to_scipy(), "csr",
                 dict(block_entries=2048, col_window=1024, row_window=256)),
    "random": (lambda: sp.random(600, 600, density=0.01,
                                 random_state=np.random.RandomState(11)).tocsr()
               + sp.eye(600), "csr",
               dict(block_entries=512, col_window=1024, row_window=256)),
    "powerlaw_hub": (lambda: _powerlaw(800, 8000, seed=3), "csr",
                     dict(block_entries=512, col_window=2048, row_window=256,
                          hub_cap=8)),
    "rectangular": (lambda: sp.random(300, 900, density=0.01,
                                      random_state=np.random.RandomState(13)).tocsr(),
                    "csr", dict(block_entries=512, col_window=1024, row_window=256)),
    "tridiagonal_coo": (_tridiagonal, "coo",
                        dict(block_entries=512, col_window=1024, row_window=128)),
    "tridiagonal_ell": (_tridiagonal, "ell",
                        dict(block_entries=512, col_window=1024, row_window=128)),
    "tridiagonal_hyb": (_tridiagonal, "hyb",
                        dict(block_entries=512, col_window=1024, row_window=128)),
}


@functools.cache
def _jax_case(name, rail):
    """(JAX matrix, x, y of the JAX rail in interpret mode)."""
    make, fmt, cfg = CASES[name]
    J = jax_from_scipy(make().tocoo(), fmt)
    x = np.random.RandomState(7).randn(J.num_cols).astype(np.float32)
    build = {"binned": jax_binned, "colsort": jax_colsort}[rail]
    y = np.asarray(jax.jit(build(J, cfg, interpret=True))(jnp.asarray(x)))
    return J, x, y


@pytest.mark.parametrize("name", sorted(CASES))
def test_binned_plain_matches_pallas(name):
    J, x, ref = _jax_case(name, "binned")
    cfg = {"hub_cap": CASES[name][2].get("hub_cap", 0)}
    fn = build_binned(port_of(J), cfg)
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["poisson9", "random", "powerlaw_hub",
                                  "rectangular", "tridiagonal_coo"])
def test_colsort_plain_matches_pallas(name):
    J, x, ref = _jax_case(name, "colsort")
    fn = build_colsort(port_of(J), {"values_per_thread": 4})
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref, **TOL)


def _skewed(seed=2):
    """Row lengths 0 to 4096 with empty rows and one 4096-entry row, and
    lengths that are not multiples of any group size."""
    rng = np.random.RandomState(seed)
    lengths = np.r_[0, 4096, rng.randint(0, 70, 300), 0, 33, 5, 1]
    indptr = np.r_[0, np.cumsum(lengths)]
    n = 5000
    col = np.concatenate([rng.choice(n, k, replace=False) for k in lengths])
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


@pytest.mark.parametrize("tpr", [0, 1, 4, 32])
@pytest.mark.parametrize("hub_cap", [0, 64])
def test_binned_plan_matches_oracle(tpr, hub_cap):
    S = _skewed()
    A = from_scipy(S, "csr", dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(A.num_cols).astype(np.float32))
    fn = build_binned(A, {"threads_per_row": tpr, "hub_cap": hub_cap})
    np.testing.assert_allclose(fn(x).numpy(), reference_spmv(A, x), **TOL)


def test_plan_bins_lists_every_row_once_with_its_group():
    lengths = np.array([0, 1, 4, 5, 9, 64, 128, 129, 1024, 1025, 3])
    perm, bins = plan_bins(np.r_[0, np.cumsum(lengths)])
    assert sorted(perm.tolist()) == list(range(lengths.size))
    group = {}
    for start, count, g in bins.tolist():
        for r in perm[start:start + count]:
            group[int(r)] = g
    # the fewest lanes leaving at most 4 entries each, up to a warp; longer
    # than hub_cap (1024): a block
    assert [group[r] for r in range(lengths.size)] == \
        [1, 1, 1, 2, 4, 16, 32, 32, 32, 0, 1]
    assert [g for _, _, g in bins.tolist()] == [1, 2, 4, 16, 32, 0]
    perm, bins = plan_bins(np.r_[0, np.cumsum(lengths)], threads_per_row=4,
                           hub_cap=100)
    assert bins.tolist() == [[0, 7, 4], [7, 4, 0]]
    assert set(GROUPS) == {1, 2, 4, 8, 16, 32}


@pytest.mark.parametrize("vpt", [1, 4, 16])
def test_colsort_long_row_across_chunks_matches_oracle(vpt):
    """A 4096-entry row spans 32 chunks of 128 entries (vpt 4)."""
    S = _skewed()
    A = from_scipy(S, "coo", dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).randn(A.num_cols).astype(np.float32))
    fn = build_colsort(A, {"values_per_thread": vpt})
    np.testing.assert_allclose(fn(x).numpy(), reference_spmv(A, x), **TOL)


@pytest.mark.parametrize("impl", ["binned", "colsort"])
def test_rails_store_bf16_and_accumulate_f32(impl):
    A = from_scipy(_skewed(), "csr", dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(A.num_cols).astype(np.float32))
    fn = build_spmv(A, {"impl": impl, "value_dtype": "bfloat16"})
    assert fn.planned_arrays["val"].dtype == torch.bfloat16
    y = fn(x)
    assert y.dtype == torch.float32
    ref = reference_spmv(A, x)
    assert np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref) < 2e-2


@pytest.mark.parametrize("impl", ["binned", "colsort", "cuda"])
@pytest.mark.parametrize("fmt", ["coo", "ell", "ellr", "hyb"])
def test_rails_plan_every_format(impl, fmt):
    """ELL's -1 slots never reach a gather: every format plans through its
    stored entries."""
    S = _tridiagonal(300).tocoo()
    S.data[::7] = 0.0                          # explicit zeros stay entries
    A = from_scipy(S, fmt, dtype=torch.float32, device="cpu")
    x = torch.linspace(-1, 1, A.num_cols)
    y = build_spmv(A, {"impl": impl})(x)
    np.testing.assert_allclose(y.numpy(), reference_spmv(A, x), **TOL)


@pytest.mark.parametrize("impl", ["binned", "colsort"])
def test_rails_refuse_what_they_cannot_plan(impl):
    empty = from_scipy(sp.coo_matrix((6, 7), dtype=np.float32), "csr", device="cpu")
    with pytest.raises(FormatConversionException):
        build_spmv(empty, {"impl": impl})
    A = from_scipy(_tridiagonal(40), "csr", dtype=torch.float32, device="cpu")
    fn = build_spmv(A, {"impl": impl})
    assert fn(torch.ones(A.num_cols, 2)).shape == (A.num_rows, 2)   # SpMM
    with pytest.raises(NotImplementedException):
        fn(torch.ones(A.num_cols, 2, 1))        # neither (n,) nor (n, k)
    with pytest.raises(InvalidInputException):
        fn(torch.ones(A.num_cols, device="meta"))
    bad = {"binned": {"threads_per_row": 3}, "colsort": {"values_per_thread": 0.5}}
    with pytest.raises(NotImplementedException):
        build_spmv(A, {"impl": impl, **bad[impl], "block_size": 96})


def test_unsorted_coo_is_sorted_for_the_colsort_plan():
    from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
    rows, cols = np.array([3, 0, 2, 0]), np.array([1, 2, 0, 0])
    A = coo_matrix(rows, cols, np.arange(1.0, 5.0, dtype=np.float32), (4, 3),
                   sort=False, device="cpu")
    fn = build_colsort(A, {})
    assert fn.planned_arrays["row"].tolist() == [0, 0, 2, 3]
    x = torch.tensor([1.0, 10.0, 100.0])
    np.testing.assert_allclose(fn(x).numpy(), reference_spmv(A, x))


def test_wrappers_count_no_launch_on_the_cpu():
    A = from_scipy(_tridiagonal(40), "csr", dtype=torch.float32, device="cpu")
    before = binned_spmv.launches, coo_spmv.launches
    x = torch.ones(A.num_cols)
    build_binned(A, {})(x)
    build_colsort(A, {})(x)
    assert (binned_spmv.launches, coo_spmv.launches) == before
