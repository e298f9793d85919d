"""The port's block multiply (SpMM: a sparse matrix times a dense block
X (n, k)) against the JAX package, on the CPU.

On the CPU the wrappers of the three SpMM kernels take their plain
PyTorch versions: shifted slices for DIA, the row bins walked one by one
for binned, a gather and an index_add_ for COO.  One small case of each is
held against the JAX package's Pallas build function run in interpret mode,
on the shapes of tests/test_pallas.py; every other case against the JAX
package's plain multiply.  Tolerances: f32 rtol = atol = 1e-4 (the
reference's SpMM tests), f64 1e-10.  The CUDA kernels are held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.formats import dense as jdense
from cusp_autotuned_tpu.formats.dense import Array2d as JaxArray2d
from cusp_autotuned_tpu.kernels.pallas_binned import build_binned as jax_binned
from cusp_autotuned_tpu.kernels.pallas_colsort import build_colsort as jax_colsort
from cusp_autotuned_tpu.kernels.pallas_dia import build_dia as jax_dia
from cusp_autotuned_tpu.ops.multiply import multiply as jax_multiply

from cusp_autotuned_tpu_torch import autotune, interop
from cusp_autotuned_tpu_torch.autotune import Tuner
from cusp_autotuned_tpu_torch.autotune.tuner import matrix_signature
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.formats import Array2d, dense
from cusp_autotuned_tpu_torch.kernels import build_spmv, default_config
from cusp_autotuned_tpu_torch.kernels.binned import (
    binned_spmm, binned_spmv, build_binned,
)
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort, coo_spmm
from cusp_autotuned_tpu_torch.kernels.dia import build_dia, dia_spmm
from cusp_autotuned_tpu_torch.operators import planned_operator
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)

from tests.torch_parity import banded, port_of

TOL = {np.float32: dict(rtol=1e-4, atol=1e-4), np.float64: dict(rtol=1e-10, atol=1e-10)}


def _X(n, k, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(n, k).astype(dtype)


def _powerlaw(n, nnz, seed=0):
    """tests/test_pallas.py:164-172: Zipf row lengths, random columns."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.7, n).astype(np.int64), n // 2)
    deg = np.maximum(deg * nnz // max(1, deg.sum()), 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    return sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                         shape=(n, n)).tocsr()


# -- the three kernels' plain versions against the Pallas kernels -------------

# name -> (JAX matrix, JAX builder, its config, k): the configurations of
# tests/test_pallas.py (:376 DIA SpMM, :250 binned SpMM, :473 colsort SpMM)
# on the smallest shapes that still reach each Pallas SpMM site (k = 100 >
# 64 for DIA; rows above hub_cap 10 for colsort's hub kernel), since every
# interpret-mode call costs time on one CPU worker
PALLAS = {
    "dia_poisson_k100": (
        lambda: jgallery.poisson5pt(12, 15, format="dia", dtype=np.float32),
        jax_dia, {"block_rows": 1024}, 100),
    "binned_poisson9_k3": (
        lambda: jax_from_scipy(jgallery.poisson9pt(12, 12, format="csr")
                               .to_scipy().tocoo(), "csr"),
        jax_binned, dict(block_entries=2048, col_window=1024, row_window=256), 3),
    "binned_poisson9_k16": (
        lambda: jax_from_scipy(jgallery.poisson9pt(12, 12, format="csr")
                               .to_scipy().tocoo(), "csr"),
        jax_binned, dict(block_entries=2048, col_window=1024, row_window=256), 16),
    "colsort_powerlaw_k3": (
        lambda: jax_from_scipy(_powerlaw(200, 2000, seed=14).tocoo(), "csr"),
        jax_colsort, dict(block_entries=2048, col_window=2048, row_window=512,
                          hub_cap=10), 3),
}


@functools.cache
def _pallas_case(name):
    make, build, cfg, k = PALLAS[name]
    J = make()
    X = _X(J.num_cols, k, 17)
    Y = np.asarray(jax.jit(build(J, cfg, interpret=True))(jnp.asarray(X)))
    return J, X, Y


@pytest.mark.parametrize("name", sorted(PALLAS))
def test_spmm_plain_matches_pallas(name):
    J, X, ref = _pallas_case(name)
    port = {"dia": build_dia, "binned": build_binned, "colsort": build_colsort}
    Y = port[name.split("_")[0]](port_of(J), {})(torch.from_numpy(X))
    assert Y.shape == ref.shape and Y.dtype == torch.float32
    np.testing.assert_allclose(Y.numpy(), ref, **TOL[np.float32])


# -- every format's block paths against the JAX package's multiply ------------

MATRICES = {
    "poisson5pt": lambda: jgallery.poisson5pt(12, 9, format="csr", dtype=np.float32)
    .to_scipy(),
    "rectangular": lambda: sp.random(60, 90, density=0.05, dtype=np.float32,
                                     random_state=np.random.RandomState(13)),
    "powerlaw": lambda: _powerlaw(300, 3000, seed=5).astype(np.float32),
}
IMPLS = {
    "dia": ("slices", "gather", "cuda"),
    "csr": ("segsum", "via_dia", "binned", "colsort"),
    "coo": ("segsum", "via_dia", "binned", "colsort"),
    "ell": ("gather", "via_dia", "binned", "colsort"),
    "ellr": ("rowlen", "via_dia", "binned", "colsort"),
    "hyb": ("default", "via_dia", "binned", "colsort"),
}


@functools.cache
def _jax_multiply(name, fmt, k, dtype=np.float32):
    S = MATRICES[name]().astype(dtype).tocoo()
    J = jax_from_scipy(S, fmt, dtype=dtype)
    X = _X(J.num_cols, k, 5, dtype)
    return J, X, np.asarray(jax_multiply(J, jnp.asarray(X)))


@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("fmt", sorted(IMPLS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_block_impls_match_jax_multiply(name, fmt, k):
    """Every impl that takes a block, through build_spmv and through
    multiply, on every format the matrix converts to (k = 1 is a block of
    one column, not a vector)."""
    J, X, ref = _jax_multiply(name, fmt, k)
    A, Xt = port_of(J), torch.from_numpy(X)
    np.testing.assert_allclose(multiply(A, Xt).numpy(), ref, **TOL[np.float32])
    for impl in IMPLS[fmt]:
        Y = build_spmv(A, {"impl": impl})(Xt)
        assert Y.shape == (A.num_rows, k), impl
        np.testing.assert_allclose(Y.numpy(), ref, **TOL[np.float32], err_msg=impl)


@pytest.mark.parametrize("impl", ["cuda", "binned", "colsort"])
def test_block_kernels_plain_f64(impl):
    J, X, ref = _jax_multiply("powerlaw" if impl != "cuda" else "poisson5pt",
                              "dia" if impl == "cuda" else "csr", 6, np.float64)
    Y = build_spmv(port_of(J), {"impl": impl})(torch.from_numpy(X))
    assert Y.dtype == torch.float64
    np.testing.assert_allclose(Y.numpy(), ref, **TOL[np.float64])


@pytest.mark.parametrize("shape,offsets,k", [
    ((300, 520), [0, 150, 320], 80),        # tests/test_pallas.py:392
    ((8, 300), [0, 1], 16),                 # wide and short, :1047
    ((520, 300), [-220, 0], 5),             # tall
])
def test_dia_spmm_rectangular_matches_jax(shape, offsets, k):
    S = banded(shape[0], shape[1], offsets, 19).astype(np.float32)
    J = jax_from_scipy(S, "dia", dtype=np.float32)
    X = _X(shape[1], k, 19)
    ref = np.asarray(jax_multiply(J, jnp.asarray(X)))
    Y = build_dia(port_of(J), {})(torch.from_numpy(X))
    np.testing.assert_allclose(Y.numpy(), ref, **TOL[np.float32])


def test_binned_spmm_all_hub_rows():
    """hub_cap 1: every row of 2-3 entries is a hub row, a block each
    (tests/test_pallas.py:489's matrix)."""
    n = 400
    S = (sp.eye(n) + sp.diags(np.full(n - 1, 2.0), 1)
         + sp.diags(np.full(n - 1, 3.0), -1)).astype(np.float32).tocoo()
    J = jax_from_scipy(S, "csr", dtype=np.float32)
    X = _X(n, 3, 16)
    fn = build_binned(port_of(J), {"hub_cap": 1})
    assert [g for _, _, g in fn.plan_stats["bins"]] == [0]
    np.testing.assert_allclose(fn(torch.from_numpy(X)).numpy(),
                               np.asarray(jax_multiply(J, jnp.asarray(X))),
                               **TOL[np.float32])


@pytest.mark.parametrize("vpt", [1, 4])
def test_coo_spmm_row_across_many_chunks(vpt):
    """A 4096-entry row spans 4096 / (32 * vpt) chunks; empty rows too."""
    rng = np.random.RandomState(2)
    lengths = np.r_[0, 4096, rng.randint(0, 70, 100), 0, 33, 5, 1]
    indptr = np.r_[0, np.cumsum(lengths)]
    n = 5000
    col = np.concatenate([rng.choice(n, k, replace=False) for k in lengths])
    S = sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]).astype(np.float32), col,
                       indptr), shape=(lengths.size, n))
    J = jax_from_scipy(S.tocoo(), "coo", dtype=np.float32)
    X = _X(n, 5, 3)
    fn = build_colsort(port_of(J), {"values_per_thread": vpt})
    np.testing.assert_allclose(fn(torch.from_numpy(X)).numpy(),
                               np.asarray(jax_multiply(J, jnp.asarray(X))),
                               **TOL[np.float32])


def test_multiply_takes_array2d_like_jax():
    J = jgallery.poisson5pt(8, 7, format="csr", dtype=np.float32)
    X = _X(J.num_cols, 5, 4)
    ref = np.asarray(jax_multiply(J, JaxArray2d.from_dense(jnp.asarray(X))))
    A = port_of(J)
    for orientation in ("c", "f"):
        B = Array2d.from_dense(torch.from_numpy(X), orientation=orientation, pitch=9
                               if orientation == "c" else None)
        np.testing.assert_allclose(multiply(A, B).numpy(), ref, **TOL[np.float32])
        op = planned_operator(A, {"impl": "binned"})
        np.testing.assert_allclose(multiply(op, B).numpy(), ref, **TOL[np.float32])


# -- Array2d against the JAX package's --------------------------------------------

@pytest.mark.parametrize("orientation", ["c", "f"])
@pytest.mark.parametrize("pitch", [None, 11])
def test_array2d_matches_jax(orientation, pitch):
    """The same logical matrix and views; the pitch defaults to the minor
    dimension here and to 128 lanes in the JAX package."""
    a = np.arange(42, dtype=np.float32).reshape(6, 7)
    J = JaxArray2d.from_dense(jnp.asarray(a), orientation=orientation, pitch=pitch)
    P = Array2d.from_dense(torch.from_numpy(a), orientation=orientation, pitch=pitch)
    minor = 7 if orientation == "c" else 6
    assert P.pitch == (pitch or minor) and J.pitch == (pitch or 128)
    assert (P.shape, P.num_entries, P.format) == (J.shape, J.num_entries, J.format)
    np.testing.assert_array_equal(np.asarray(P), np.asarray(J))
    np.testing.assert_array_equal(P.to_dense().numpy(), np.asarray(J.to_dense()))
    np.testing.assert_array_equal(P.row(2).numpy(), np.asarray(J.row(2)))
    np.testing.assert_array_equal(P.column(4).numpy(), np.asarray(J.column(4)))
    np.testing.assert_array_equal(np.asarray(P.T), np.asarray(J.T))
    assert P.T.orientation == J.T.orientation and P.T.shape == J.T.shape
    sub, sub_j = P.view(slice(1, 5), slice(2, 6)), J.view(slice(1, 5), slice(2, 6))
    np.testing.assert_array_equal(np.asarray(sub), np.asarray(sub_j))
    assert float(P[3, 5]) == float(J[3, 5])
    Q = interop.from_reference("array2d", {"values": np.asarray(J.values)}, J.shape,
                               orientation=orientation, device="cpu")
    assert Q.pitch == J.pitch
    np.testing.assert_array_equal(np.asarray(Q), np.asarray(J))
    P.row(0)[:] = -1                          # a view of the buffer
    assert float(P[0, 6]) == -1.0


def test_array2d_constructors_match_jax():
    P = dense.array2d(3, 4, fill=2.5, orientation="f", device="cpu")
    J = jdense.array2d(3, 4, fill=2.5, orientation="f")
    np.testing.assert_array_equal(np.asarray(P), np.asarray(J))
    buf = np.arange(20, dtype=np.float32).reshape(4, 5)
    V = dense.make_array2d_view(torch.from_numpy(buf), 4, 3)
    np.testing.assert_array_equal(np.asarray(V),
                                  np.asarray(jdense.make_array2d_view(buf, 4, 3)))
    with pytest.raises(ValueError):
        dense.make_array2d_view(torch.from_numpy(buf), 5, 3)
    with pytest.raises(ValueError):
        Array2d.from_dense(torch.ones(3, 4), pitch=3)
    v = dense.array1d(9, fill=1.5, device="cpu")
    np.testing.assert_array_equal(v.numpy(), np.asarray(jdense.array1d(9, fill=1.5)))
    x = torch.arange(10.0)
    np.testing.assert_array_equal(dense.array1d_view(x, 1, 8, 3).numpy(),
                                  np.asarray(jdense.array1d_view(np.arange(10.0), 1, 8, 3)))


# -- the registry, the tuner and the operators on blocks -----------------------

def test_default_config_for_blocks_is_plain_on_the_cpu():
    for fmt in ("dia", "csr", "coo", "ell", "ellr", "hyb"):
        A = convert(from_scipy(banded(40, 40, [-1, 0, 1], 0), "csr",
                               device="cpu"), fmt)
        X = torch.ones(40, 3)
        assert default_config(A, X) == default_config(A), fmt


def test_tuner_spmm_signature_and_iteration():
    """tests/test_pallas.py:417's case: SpMM keys the tuner per k, walks it,
    and tune_iteration serves the block; the csr `cuda` impl (vectors only)
    is a skippable result."""
    J = jgallery.poisson5pt(20, 20, format="dia", dtype=np.float32)
    A = port_of(J)
    x1 = torch.ones(A.num_cols)
    x2 = torch.ones(A.num_cols, 8)
    assert matrix_signature(A, x1) != matrix_signature(A, x2)
    assert "k=8" in matrix_signature(A, x2)
    t = Tuner(measure=False)
    results = t.tune(A, x2, reference_computation=reference_spmv)
    assert all(r.is_valid() for r in results)
    ref = np.asarray(jax_multiply(J, jnp.ones((A.num_cols, 8), jnp.float32)))
    np.testing.assert_allclose(t.tune_iteration(A, x2).numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    C = convert(A, "csr")
    results = {r.configuration["impl"]: r.status.value
               for r in t.tune(C, x2, reference_computation=reference_spmv)}
    assert results["cuda"] == "CompilationFailed"
    assert {results[i] for i in ("segsum", "binned", "colsort", "via_dia")} == {"Ok"}


def test_tuned_operator_and_choose_format_on_blocks(monkeypatch):
    from cusp_autotuned_tpu_torch.autotune import tuner as tuner_mod
    t = Tuner(measure=False)
    monkeypatch.setattr(tuner_mod, "_global_tuner", t)
    J = jgallery.poisson5pt(10, 12, format="csr", dtype=np.float32)
    A = port_of(J)
    X = torch.from_numpy(_X(A.num_cols, 4, 8))
    ref = np.asarray(jax_multiply(J, jnp.asarray(X.numpy())))
    op = autotune.tuned_operator(A, X, tune_first=True)
    assert t.results[matrix_signature(A, X)]
    assert (op.num_rows, op.num_cols, op.dtype) == (120, 120, torch.float32)
    np.testing.assert_allclose(op(X).numpy(), ref, rtol=1e-4, atol=1e-4)
    B, cfg = autotune.choose_format(A, X, formats=("csr", "dia"),
                                    reference_computation=reference_spmv, tuner=t)
    np.testing.assert_allclose(build_spmv(B, cfg)(X).numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    autotune.enable()
    try:
        Y = multiply(A, Array2d.from_dense(X))
    finally:
        autotune.disable()
    np.testing.assert_allclose(Y.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_block_wrappers_raise_and_count_no_launch_on_the_cpu():
    A = from_scipy(banded(50, 50, [-2, 0, 3], 1), "csr", dtype=torch.float32,
                   device="cpu")
    counters = (dia_spmm, binned_spmm, binned_spmv, coo_spmm)
    before = [c.launches for c in counters]
    X = torch.ones(50, 3)
    for impl in ("binned", "colsort"):
        fn = build_spmv(A, {"impl": impl})
        fn(X)
        with pytest.raises(NotImplementedException):
            fn(torch.ones(50, 3, 1))                 # neither (n,) nor (n, k)
        with pytest.raises(InvalidInputException):
            fn(torch.ones(50, 3, device="meta"))     # neither CPU nor CUDA
    fn = build_dia(convert(A, "dia"), {})
    fn(X)
    with pytest.raises(InvalidInputException):
        fn(torch.ones(50, 3, device="meta"))
    assert [c.launches for c in counters] == before
