"""The vendor-library baseline (backend/tsparse.py) against the JAX
package's backend/jsparse.py, the device-time module's CPU readings, and
the remaining public names' twins, on the CPU.

to_torch_sparse and from_torch_sparse round-trip to the entries that
to_bcoo and from_bcoo give (indices, values, shape), on every format, in
f32, f64 and complex64, with explicit zeros (DIA drops a zero in both
packages: it cannot tell one from padding).  cusparse_spmv matches
bcoo_spmv at rtol 1e-5 in f32 and 1e-12 in f64; `cusparse` stands in no
tuning space."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from cusp_autotuned_tpu.backend import jsparse
from cusp_autotuned_tpu.formats.coo import coo_matrix as jcoo_matrix
from cusp_autotuned_tpu.ops.convert import convert as jconvert

from cusp_autotuned_tpu_torch import formats, ops, solvers, utils
from cusp_autotuned_tpu_torch.autotune.space import configurations_for
from cusp_autotuned_tpu_torch.backend import tsparse
from cusp_autotuned_tpu_torch.backend.reference import reference_spmv, to_scipy
from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
from cusp_autotuned_tpu_torch.utils import device_time
from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import ALL_FORMATS

DTYPES = (np.float32, np.float64, np.complex64)
SPMV_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def with_zeros(fmt, dtype):
    """A JAX container of a seeded 30 x 24 matrix with empty rows, one
    long row and three explicit zeros, in `fmt`."""
    rng = np.random.RandomState(3)
    S = sp.random(30, 24, density=0.15, random_state=rng, format="coo")
    row = np.r_[S.row, np.full(12, 7), [0, 11, 29]]
    col = np.r_[S.col, np.arange(12), [23, 5, 0]]
    key = np.unique(row * 24 + col, return_index=True)[1]
    row, col = row[key], col[key]
    val = rng.uniform(-2, 2, row.size) + (1j * rng.uniform(-1, 1, row.size)
                                          if np.dtype(dtype).kind == "c" else 0)
    val[np.isin(row * 24 + col, [0 * 24 + 23, 11 * 24 + 5, 29 * 24 + 0])] = 0
    A = jcoo_matrix(row, col, val.astype(dtype), (30, 24))
    return A if fmt == "coo" else jconvert(A, fmt)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_round_trip_equals_bcoo(fmt, dtype):
    JA = with_zeros(fmt, dtype)
    M = jsparse.to_bcoo(JA)
    want_idx, want_val = np.asarray(M.indices), np.asarray(M.data)
    A = port_of(JA)
    C = tsparse.to_torch_sparse(A, "coo")
    assert tuple(C.shape) == tuple(M.shape) and C.is_coalesced()
    np.testing.assert_array_equal(C.indices().numpy().T, want_idx)
    np.testing.assert_array_equal(C.values().numpy(), want_val)
    S = tsparse.to_torch_sparse(A)
    assert S.layout == torch.sparse_csr and S.col_indices().dtype == torch.int32
    np.testing.assert_array_equal(S.col_indices().numpy(), want_idx[:, 1])
    np.testing.assert_array_equal(S.values().numpy(), want_val)
    np.testing.assert_array_equal(np.diff(S.crow_indices().numpy()),
                                  np.bincount(want_idx[:, 0], minlength=M.shape[0]))
    for layout in (S, C):
        B = tsparse.from_torch_sparse(layout, fmt)
        JB = jsparse.from_bcoo(M, fmt)
        assert B.format == JB.format == fmt
        got, want = to_scipy(B).tocoo(), sp.coo_matrix(
            (want_val, (want_idx[:, 0], want_idx[:, 1])), shape=M.shape)
        np.testing.assert_array_equal(got.toarray(), want.toarray())
        assert B.nnz == JB.nnz


def test_repeated_entries_are_summed():
    from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
    A = coo_matrix([0, 0, 1, 2], [1, 1, 0, 2], [1.0, 2.0, 0.0, 4.0], (3, 3),
                   device="cpu")
    S = tsparse.to_torch_sparse(A)
    np.testing.assert_array_equal(S.crow_indices().numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(S.values().numpy(), [3.0, 0.0, 4.0])


@pytest.mark.parametrize("dtype", (np.float32, np.float64), ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_cusparse_spmv_matches_bcoo_spmv(fmt, dtype):
    JA = with_zeros(fmt, dtype)
    rng = np.random.RandomState(4)
    x = rng.randn(JA.num_cols).astype(dtype)
    X = rng.randn(JA.num_cols, 3).astype(dtype)
    fn = tsparse.cusparse_spmv(port_of(JA))
    for v in (x, X):
        want = np.asarray(jsparse.bcoo_spmv(JA)(jnp.asarray(v)))
        np.testing.assert_allclose(fn(torch.from_numpy(v)).numpy(), want,
                                   rtol=SPMV_RTOL[dtype], atol=SPMV_RTOL[dtype])


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_cusparse_is_an_explicit_baseline_only(fmt):
    JA = with_zeros(fmt, np.float32)
    A = port_of(JA)
    assert all(c["impl"] != "cusparse" for c in configurations_for(A))
    x = torch.linspace(-1, 1, A.num_cols)
    if fmt == "dia":            # the JAX package has no bcoo impl for DIA
        with pytest.raises(NotImplementedException):
            build_spmv(A, {"impl": "cusparse"})
        return
    y = build_spmv(A, {"impl": "cusparse"})(x)
    np.testing.assert_allclose(y.numpy(), reference_spmv(A, x), rtol=1e-5, atol=1e-6)


def test_device_time_reads_nothing_on_the_cpu():
    A = port_of(with_zeros("csr", np.float32))
    fn = build_spmv(A, {"impl": "segsum"})
    x = torch.ones(A.num_cols)
    assert device_time.capture_trace(fn, x, 2) == []
    assert device_time.device_us_per_call(fn, x, reps=2) is None
    assert device_time.hlo_breakdown(fn, x, reps=2) == []
    assert device_time.device_ms(lambda: fn(x), 2) == (None, None, {})
    assert device_time.kernels_a_call(fn, x) == 0


def test_device_time_groups_kernels_by_call():
    """A call's time sums its kernels; a call with a dropped record is left
    out of the median; span_name keeps matching kernels."""
    events = [(0, "void ns::coo_chunk_kernel<float>(int)", 3.0),
              (0, "coo_fold_kernel", 1.0),
              (1, "void ns::coo_chunk_kernel<float>(int)", 5.0),
              (1, "coo_fold_kernel", 1.0),
              (2, "coo_fold_kernel", 9.0),           # its chunk was dropped
              (3, "void ns::coo_chunk_kernel<float>(int)", 4.0),
              (3, "coo_fold_kernel", 2.0)]
    calls = device_time._complete_calls(events)
    assert sorted(calls) == [0, 1, 3]
    assert [device_time.kernel_name(k) for k, _ in calls[0]] == [
        "coo_chunk_kernel", "coo_fold_kernel"]
    assert device_time._complete_calls([]) == {}


def test_device_time_functions_on_captured_events(monkeypatch):
    events = [(c, name, us) for c in range(3)
              for name, us in (("chunk", 2.0 + c), ("fold", 1.0))]
    monkeypatch.setattr(device_time, "capture_trace", lambda fn, x, reps: events)
    assert device_time.device_us_per_call(None, None) == 4.0
    assert device_time.device_us_per_call(None, None, span_name="fold") == 1.0
    assert device_time.device_us_per_call(None, None, span_name="none") is None
    assert device_time.hlo_breakdown(None, None, top=1) == [("chunk", 3.0, None, None)]


# -- the remaining public names ----------------------------------------------

def test_format_class_and_from_scipy():
    from cusp_autotuned_tpu import formats as jformats
    for name in ("coo", "csr", "dia", "ell", "ellr", "hyb", "permutation"):
        assert formats.format_class(name).__name__ == jformats.format_class(name).__name__
    with pytest.raises(ValueError):
        formats.format_class("bsr")
    S = sp.random(9, 7, density=0.3, random_state=np.random.RandomState(0),
                  format="csr", dtype=np.float32)
    S.indices = S.indices.copy()
    for build, jbuild in ((formats.coo_from_scipy, jformats.coo_from_scipy),
                          (formats.csr_from_scipy, jformats.csr_from_scipy)):
        A, JA = build(S, device="cpu"), jbuild(S)
        assert A.format == JA.format and A.nnz == JA.nnz
        np.testing.assert_array_equal(to_scipy(A).toarray(), S.toarray())
        np.testing.assert_array_equal(A.col.numpy(), np.asarray(JA.col))


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_copy_and_to_dense(fmt):
    from cusp_autotuned_tpu import ops as jops
    JA = with_zeros(fmt, np.float64)
    A = port_of(JA)
    B = ops.copy(A)
    assert type(B) is type(A)
    for f in dataclasses.fields(A):
        a, b = getattr(A, f.name), getattr(B, f.name)
        if isinstance(a, torch.Tensor):
            assert a is not b and torch.equal(a, b)
    np.testing.assert_array_equal(ops.to_dense(A).numpy(),
                                  np.asarray(jops.to_dense(JA)))


def test_monitor_record_matches_the_jax_state():
    from cusp_autotuned_tpu import solvers as jsolvers
    b = np.ones(4)
    s = solvers.monitor_init(torch.from_numpy(b), 5)
    js = jsolvers.monitor_init(jnp.asarray(b), 5)
    for r in (3.0, 1.5):
        k, history = int(s.k), s.residuals.nan_to_num(-1.0)
        t = solvers.monitor_record(s, torch.tensor(r, dtype=torch.float64))
        # the state passed in is left as it was
        assert int(s.k) == k and torch.equal(s.residuals.nan_to_num(-1.0), history)
        s, js = t, jsolvers.monitor_record(js, jnp.asarray(r))
    assert int(s.k) == int(js.k) and float(s.r_norm) == float(js.r_norm)
    np.testing.assert_array_equal(s.residuals.numpy(), np.asarray(js.residuals))


def test_coarse_lu_reference_spgemm_and_configure(monkeypatch):
    from cusp_autotuned_tpu.backend.reference import reference_spgemm as jspgemm
    from cusp_autotuned_tpu_torch.backend.reference import reference_spgemm
    from cusp_autotuned_tpu_torch.precond import aggregation, multilevel
    assert aggregation.CoarseLU is multilevel.CoarseLU
    JA = with_zeros("csr", np.float64)
    JB = jconvert(jcoo_matrix(np.arange(24), np.arange(24) % 5, np.ones(24),
                              (24, 5)), "csr")
    want, got = jspgemm(JA, JB), reference_spgemm(port_of(JA), port_of(JB))
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    cfg = utils.get_config()
    monkeypatch.setattr(cfg, "search_low_precision", cfg.search_low_precision)
    assert utils.configure(search_low_precision=True).search_low_precision
    with pytest.raises(AttributeError):
        utils.configure(vmem_budget_bytes=1)
