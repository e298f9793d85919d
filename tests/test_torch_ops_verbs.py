"""The port's remaining verbs against the JAX package's, on the CPU:
elementwise/add/subtract, sort, format_utils, the BLAS verbs (complex
too), LAPACK (sytrf on an indefinite matrix, stsv), verify, printing,
functional, iterator_utils and the call-tree tracer (the cases of
tests/test_ops.py and tests/test_aux.py:13-46), each on the same seeded
numpy input in both packages.  Tolerances: f32 rtol 1e-5, atol 1e-6; f64
rtol 1e-10; integer results and printed text exactly."""

import dataclasses
import io
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cusp_autotuned_tpu as jct
from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.ops import (
    blas as jblas, format_utils as jfu, functional as jfn, iterator_utils as jit,
    lapack as jlapack, printing as jprinting, sort as jsort, verify as jverify,
)
from cusp_autotuned_tpu.utils.trace import trace as jtrace

import cusp_autotuned_tpu_torch as ct
from cusp_autotuned_tpu_torch import gallery
from cusp_autotuned_tpu_torch.ops import (
    blas, format_utils as fu, functional as fn, iterator_utils as it, lapack,
    printing, sort, verify,
)
from cusp_autotuned_tpu_torch.utils.trace import trace

from tests.torch_parity import one_thread, port_of, skewed_random  # noqa: F401
from tests.util import ALL_FORMATS, build, example_matrices

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-10, atol=1e-12)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -- elementwise --------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["coo", "csr", "ell", "dia"])
def test_elementwise_matches_jax(fmt):
    S1 = example_matrices()["small4x4"]
    S2 = example_matrices()["small4x4"].T.tocoo()
    JA, JB = build(S1, fmt), build(S2, fmt)
    A, B = port_of(JA), port_of(JB)
    for port_c, jax_c in ((ct.add(A, B), jct.add(JA, JB)),
                          (ct.subtract(A, B), jct.subtract(JA, JB)),
                          (ct.elementwise(A, B, np.maximum),
                           jct.elementwise(JA, JB, np.maximum))):
        assert port_c.format == jax_c.format == fmt
        assert port_c.nnz == jax_c.nnz
        np.testing.assert_allclose(port_c.to_scipy().toarray(),
                                   np.asarray(jct.backend.reference.to_scipy(jax_c).todense()),
                                   **F32)


def test_elementwise_union_keeps_explicit_entries():
    """The union pattern keeps an entry whose value is 0 (a zero diagonal
    added to a grid graph stays stored), as the JAX package's does."""
    G = gallery.grid2d(4, 5, device="cpu")
    n = G.num_rows
    Z = ct.formats.csr_matrix(np.arange(n + 1), np.arange(n), np.zeros(n, np.float32),
                              (n, n), device="cpu")
    JG = jgallery.grid2d(4, 5)
    JZ = build(sp.coo_matrix((np.zeros(n, np.float32), (np.arange(n), np.arange(n))),
                             shape=(n, n)), "csr")
    C, JC = ct.add(G, Z), jct.add(JG, JZ)
    assert C.nnz == JC.nnz == G.nnz + n
    np.testing.assert_array_equal(C.indptr.numpy(), np.asarray(JC.indptr))


def test_elementwise_shape_mismatch_raises():
    A = port_of(build(example_matrices()["small4x4"], "coo"))
    B = port_of(build(example_matrices()["rect3x5"], "coo"))
    with pytest.raises(ct.InvalidInputException):
        ct.add(A, B)


# -- sort ---------------------------------------------------------------------

def test_sorting_matches_jax():
    row, col, val = [2, 0, 1, 0], [1, 2, 0, 0], [1.0, 2.0, 3.0, 4.0]
    r, c, v = sort.sort_by_row_and_column(_t(row), _t(col), _t(val))
    jr, jc, jv = jsort.sort_by_row_and_column(np.asarray(row, np.int32),
                                              np.asarray(col, np.int32),
                                              np.asarray(val))
    for a, b in ((r, jr), (c, jc), (v, jv)):
        np.testing.assert_array_equal(_np(a), _np(b))
    k, p = sort.counting_sort_by_key(_t([3, 1, 2]), _t([30, 10, 20]))
    jk, jp = jsort.counting_sort_by_key(np.array([3, 1, 2]), np.array([30, 10, 20]))
    np.testing.assert_array_equal(_np(k), _np(jk))
    np.testing.assert_array_equal(_np(p), _np(jp))
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 5, 40)
    np.testing.assert_array_equal(_np(sort.counting_sort(_t(keys))),
                                  _np(jsort.counting_sort(keys)))
    rows, cols = rng.randint(0, 4, 40).astype(np.int32), np.arange(40, dtype=np.int32)
    for a, b in zip(sort.sort_by_row(_t(rows), _t(cols), _t(cols * 1.0)),
                    jsort.sort_by_row(rows, cols, cols * 1.0)):
        np.testing.assert_array_equal(_np(a), _np(b))      # stable in column order


# -- format_utils ---------------------------------------------------------------

def test_offsets_indices_roundtrip_matches_jax():
    S = example_matrices()["rand50x40"]
    JA = build(S, "csr")
    A = port_of(JA)
    npad = A.col.shape[0]
    rows = fu.offsets_to_indices(A.indptr, npad)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(
        jfu.offsets_to_indices(JA.indptr, JA.nnz_padded)))
    np.testing.assert_array_equal(rows.numpy(), A.row.numpy())
    back = fu.indices_to_offsets(rows, A.num_rows)
    np.testing.assert_array_equal(back.numpy(), A.indptr.numpy())
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jfu.indices_to_offsets(jfu.offsets_to_indices(JA.indptr, JA.nnz_padded),
                               JA.num_rows)))


def test_planning_heuristics_match_jax():
    S = example_matrices()["tri37"]
    assert fu.count_diagonals(37, 37, S.row, S.col) == 3 == jfu.count_diagonals(
        37, 37, S.row, S.col)
    for seed in (1, 2):
        Sk = skewed_random(20000, seed)
        ip = Sk.indptr
        assert fu.compute_max_entries_per_row(_t(ip)) == jfu.compute_max_entries_per_row(ip)
        for kw in ({}, dict(relative_speed=1.5, breakeven_threshold=64)):
            assert (fu.compute_optimal_entries_per_row(ip, **kw)
                    == jfu.compute_optimal_entries_per_row(ip, **kw))
    assert fu.compute_max_entries_per_row(np.zeros(1)) == 0


# -- blas -----------------------------------------------------------------------

def test_blas_level1_matches_jax():
    rng = np.random.RandomState(0)
    x, y, z = (rng.randn(16).astype(np.float32) for _ in range(3))
    X, Y, Z = _t(x), _t(y), _t(z)
    pairs = [
        (blas.dot(X, Y), jblas.dot(x, y)), (blas.axpy(X, Y, 2.0), jblas.axpy(x, y, 2.0)),
        (blas.axpby(X, Y, 2.0, 3.0), jblas.axpby(x, y, 2.0, 3.0)),
        (blas.axpbypcz(X, Y, Z, 2.0, -1.0, 0.5), jblas.axpbypcz(x, y, z, 2.0, -1.0, 0.5)),
        (blas.xmy(X, Y), jblas.xmy(x, y)), (blas.copy(X), jblas.copy(x)),
        (blas.scal(X, -3.0), jblas.scal(x, -3.0)), (blas.asum(X), jblas.asum(x)),
        (blas.nrm1(X), jblas.nrm1(x)), (blas.nrm2(X), jblas.nrm2(x)),
        (blas.nrmmax(X), jblas.nrmmax(x)), (blas.fill(X, 7.0), jblas.fill(x, 7.0)),
        (blas.fill(4, 2.5, device="cpu"), jblas.fill(4, 2.5)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert int(blas.amax(X)) == int(jblas.amax(x)) == int(np.argmax(np.abs(x)))
    assert blas.copy(X) is not X


def test_blas_complex_dot_and_dotc_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(12) + 1j * rng.randn(12)
    y = rng.randn(12) - 1j * rng.randn(12)
    d, dc = blas.dot(_t(x), _t(y)), blas.dotc(_t(x), _t(y))
    np.testing.assert_allclose(_np(d), _np(jblas.dot(x, y)), **F64)
    np.testing.assert_allclose(_np(dc), _np(jblas.dotc(x, y)), **F64)
    np.testing.assert_allclose(_np(dc), np.vdot(x, y), **F64)
    assert abs(complex(d) - complex(dc)) > 1e-3
    np.testing.assert_allclose(_np(blas.nrm2(_t(x))), _np(jblas.nrm2(x)), **F64)
    assert int(blas.amax(_t(x))) == int(jblas.amax(x))


def test_blas_level2_level3_match_jax():
    rng = np.random.RandomState(2)
    A = rng.randn(8, 8).astype(np.float32)
    B = rng.randn(8, 5).astype(np.float32)
    C = rng.randn(8, 5).astype(np.float32)
    x, y = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)
    L = (np.tril(A) + 8 * np.eye(8)).astype(np.float32)
    U = L.T.copy()
    tA, tB, tC, tx, ty, tL, tU = map(_t, (A, B, C, x, y, L, U))
    pairs = [
        (blas.gemv(tA, tx), jblas.gemv(A, x)),
        (blas.gemv(tA, tx, 2.0, 0.5, ty), jblas.gemv(A, x, 2.0, 0.5, y)),
        (blas.symv(tA, tx, 1.5), jblas.symv(A, x, 1.5)),
        (blas.ger(tx, ty, tA, 2.0), jblas.ger(x, y, A, 2.0)),
        (blas.syr(tx), jblas.syr(x)), (blas.trmv(tL, tx), jblas.trmv(L, x)),
        (blas.gemm(tA, tB), jblas.gemm(A, B)),
        (blas.gemm(tA, tB, 2.0, -1.0, tC), jblas.gemm(A, B, 2.0, -1.0, C)),
        (blas.symm(tA, tB, 0.5), jblas.symm(A, B, 0.5)),
        (blas.syrk(tB.T.contiguous(), 1.0, 2.0, _t(A[:5, :5])),
         jblas.syrk(B.T, 1.0, 2.0, A[:5, :5])),
        (blas.trmm(tL, tB, 3.0), jblas.trmm(L, B, 3.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    for lower, M, tM in ((True, L, tL), (False, U, tU)):
        for unit in (False, True):
            np.testing.assert_allclose(
                _np(blas.trsv(tM, tx, lower=lower, unit_diagonal=unit)),
                _np(jblas.trsv(M, x, lower=lower, unit_diagonal=unit)), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(
                _np(blas.trsm(tM, tB, lower=lower, unit_diagonal=unit)),
                _np(jblas.trsm(M, B, lower=lower, unit_diagonal=unit)), rtol=1e-4, atol=1e-5)


# -- lapack ---------------------------------------------------------------------

def test_lapack_suite_matches_jax():
    rng = np.random.RandomState(1)
    A = rng.randn(10, 10)
    A = A @ A.T + 10 * np.eye(10)
    b = rng.randn(10)
    Bm = rng.randn(10, 3)
    tA, tb, tB = _t(A), _t(b), _t(Bm)
    for rhs, trhs in ((b, tb), (Bm, tB)):
        np.testing.assert_allclose(_np(lapack.gesv(tA, trhs)),
                                   _np(jlapack.gesv(A, rhs)), **F64)
        np.testing.assert_allclose(_np(lapack.getrs(lapack.getrf(tA), trhs)),
                                   _np(jlapack.getrs(jlapack.getrf(A), rhs)), **F64)
        for lower in (True, False):
            L = lapack.potrf(tA, lower=lower)
            np.testing.assert_allclose(_np(L), _np(jlapack.potrf(A, lower=lower)), **F64)
            np.testing.assert_allclose(
                _np(lapack.potrs(L, trhs, lower=lower)),
                _np(jlapack.potrs(jlapack.potrf(A, lower=lower), rhs, lower=lower)), **F64)
    w, _ = lapack.syev(tA)
    np.testing.assert_allclose(_np(w), _np(jlapack.syev(A)[0]), **F64)
    T = np.tril(A)
    for lower, M in ((True, T), (False, T.T.copy())):
        np.testing.assert_allclose(_np(lapack.trtrs(_t(M), tb, lower=lower)),
                                   _np(jlapack.trtrs(M, b, lower=lower)), **F64)
        np.testing.assert_allclose(_np(lapack.trtri(_t(M), lower=lower)),
                                   _np(jlapack.trtri(M, lower=lower)), **F64)
    u, s, vh = lapack.gesvd(tA)
    np.testing.assert_allclose(_np(s), _np(jlapack.gesvd(A)[1]), **F64)
    np.testing.assert_allclose(_np(u) @ np.diag(_np(s)) @ _np(vh), A, **F64)
    alphas, betas = np.array([2.0, 2.0, 2.0]), np.array([-1.0, -1.0])
    w, v = lapack.stev(alphas, betas, device="cpu")
    jw, jv = jlapack.stev(alphas, betas)
    np.testing.assert_allclose(_np(w), _np(jw), **F64)
    np.testing.assert_allclose(np.abs(_np(v)), np.abs(_np(jv)), **F64)


def test_lapack_sytrf_indefinite_and_stsv_match_jax():
    """tests/test_ops.py:193: Bunch-Kaufman on an indefinite matrix (host
    LAPACK in both packages) and the O(n) tridiagonal solve."""
    rng = np.random.RandomState(7)
    A = rng.randn(16, 16)
    A = (A + A.T) / 2
    b = rng.randn(16)
    fact = lapack.sytrf(_t(A))
    assert fact[0] == "bk"
    x = lapack.sytrs(fact, _t(b))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    np.testing.assert_allclose(_np(x), _np(jlapack.sytrs(jlapack.sytrf(A), b)), **F64)
    np.testing.assert_allclose(A @ _np(x), b, rtol=1e-8, atol=1e-8)
    n = 200
    al, be = rng.rand(n) + 2.0, rng.rand(n - 1) * 0.5
    T = np.diag(al) + np.diag(be, 1) + np.diag(be, -1)
    for rhs in (rng.randn(n), rng.randn(n, 3)):
        x1 = lapack.stsv(_t(al), _t(be), _t(rhs))
        np.testing.assert_allclose(_np(x1), _np(jlapack.stsv(al, be, rhs)), **F64)
        np.testing.assert_allclose(T @ _np(x1), rhs, rtol=1e-10, atol=1e-10)


# -- verify, printing -------------------------------------------------------------

def test_verify_matches_jax():
    S = example_matrices()["small4x4"]
    for fmt in ALL_FORMATS:
        A = port_of(build(S, fmt))
        assert verify.is_valid_matrix(A)
        verify.assert_is_valid_matrix(A)
    assert ct.is_valid_matrix(ct.formats.permutation_matrix([2, 0, 1], device="cpu"))
    assert not verify.is_valid_matrix(ct.formats.permutation_matrix([2, 0, 2], device="cpu"))
    JA = build(S, "csr")
    jbad = dataclasses.replace(JA, indptr=JA.indptr.at[0].set(1))
    bad = port_of(jbad)
    out, jout = io.StringIO(), io.StringIO()
    assert not verify.is_valid_matrix(bad, out)
    assert not jverify.is_valid_matrix(jbad, jout)
    assert out.getvalue() == jout.getvalue() != ""
    with pytest.raises(ct.InvalidInputException):
        verify.assert_is_valid_matrix(bad)
    with pytest.raises(ct.InvalidInputException):
        verify.assert_same_dimensions(port_of(build(S, "coo")),
                                      port_of(build(example_matrices()["rect3x5"], "coo")))


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell", "hyb"])
def test_print_and_spy_text_match_jax(fmt):
    S = example_matrices()["widerow"]
    JA = build(S, fmt)
    A = port_of(JA)
    for port_fn, jax_fn in ((printing.print_matrix, jprinting.print_matrix),
                            (printing.spy, jprinting.spy)):
        out, jout = io.StringIO(), io.StringIO()
        port_fn(A, out)
        jax_fn(JA, jout)
        assert out.getvalue() == jout.getvalue()


def test_print_arrays_and_svg_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    for a in (rng.randn(5).astype(np.float32), rng.randn(3, 4)):
        out, jout = io.StringIO(), io.StringIO()
        printing.print_matrix(_t(a), out)
        jprinting.print_matrix(a, jout)
        assert out.getvalue() == jout.getvalue()
    S = example_matrices()["tri37"]
    printing.spy_svg(port_of(build(S, "coo")), tmp_path / "p.svg")
    jprinting.spy_svg(build(S, "coo"), tmp_path / "j.svg")
    assert (tmp_path / "p.svg").read_bytes() == (tmp_path / "j.svg").read_bytes()
    fig = printing.spy_plot(port_of(build(S, "coo")), tmp_path / "p.png")
    if fig is None:
        assert "matplotlib" not in sys.modules
    else:
        assert (tmp_path / "p.png").stat().st_size > 0


# -- functional, iterator_utils -------------------------------------------------------

def test_functional_matches_jax():
    x = np.array([1.0, 4.0, 9.0])
    np.testing.assert_allclose(_np(fn.divide_value(2.0)(_t(x))),
                               _np(jfn.divide_value(2.0)(x)))
    m = np.array([4, -5, 6])
    np.testing.assert_array_equal(_np(fn.modulus_value(3)(_t(m))),
                                  _np(jfn.modulus_value(3)(m)))
    a, b = (x, x * 2), (x * 3, x * 4)
    for got, want in zip(fn.sum_pair(tuple(map(_t, a)), tuple(map(_t, b))),
                         jfn.sum_pair(a, b)):
        np.testing.assert_allclose(_np(got), _np(want))
    np.testing.assert_allclose(_np(fn.constant_functor(7.0)(_t(x))),
                               _np(jfn.constant_functor(7.0)(x)))
    v = np.array([-1, 0, 4, 5])
    np.testing.assert_array_equal(_np(fn.valid_index(5)(_t(v))),
                                  _np(jfn.valid_index(5)(v)))


def test_iterator_utils_match_jax():
    np.testing.assert_array_equal(_np(it.counting_array(4, 2, device="cpu")),
                                  _np(jit.counting_array(4, 2)))
    np.testing.assert_array_equal(_np(it.constant_array(3, 7.0, device="cpu")),
                                  _np(jit.constant_array(3, 7.0)))
    np.testing.assert_array_equal(_np(it.join(_t([1, 2]), _t([3]))),
                                  _np(jit.join(np.array([1, 2]), np.array([3]))))
    np.testing.assert_array_equal(_np(it.strided(torch.arange(10), 3)),
                                  _np(jit.strided(np.arange(10), 3)))
    np.testing.assert_array_equal(_np(it.strided_range(10, 4, device="cpu")),
                                  _np(jit.strided_range(10, 4)))
    r1 = it.random_array(16, seed=1, device="cpu")
    assert torch.equal(r1, it.random_array(16, seed=1, device="cpu"))
    assert not torch.equal(r1, it.random_array(16, seed=2, device="cpu"))
    assert bool(((r1 >= 0) & (r1 < 1)).all())
    ri = it.random_array(64, seed=1, dtype=torch.int32, device="cpu")
    assert ri.dtype == torch.int32 and len(set(ri.tolist())) > 32


# -- the tracer (tests/test_aux.py:13-46) ------------------------------------------------

def test_trace_records_eager_verbs():
    A = gallery.poisson5pt(8, 8, format="csr", dtype=torch.float64, device="cpu")
    b = torch.ones(64, dtype=torch.float64)
    with trace() as t:
        ct.multiply(A, b)
        B = ct.convert(A, "ell")
        ct.transpose(B)
    counts = t.counts()
    assert counts.get("multiply", 0) >= 1
    assert counts.get("convert", 0) >= 1
    assert counts.get("transpose", 0) >= 1
    buf = io.StringIO()
    t.print(buf)
    out = buf.getvalue()
    assert "multiply(csr<64x64>" in out and "ms" in out
    m = sys.modules["cusp_autotuned_tpu_torch.ops.multiply"]
    assert m.multiply.__name__ == "multiply" and not hasattr(m.multiply, "__wrapped__")
    assert ct.multiply is m.multiply and ct.ops.multiply is m.multiply


def test_trace_nesting_matches_jax():
    A = gallery.poisson5pt(6, 6, format="coo", device="cpu")
    with trace() as t:
        ct.multiply(A, A)           # spgemm nests under multiply
        ct.add(A, A)                # elementwise under add's call
    names = [(r.name, r.depth) for r in t.records]
    JA = jgallery.poisson5pt(6, 6, format="coo")
    with jtrace() as jt:
        jct.multiply(JA, JA)
        jct.add(JA, JA)
    assert names == [(r.name, r.depth) for r in jt.records]
    assert ("multiply", 0) in names
    assert any(n == "spgemm" and d >= 1 for n, d in names)
    assert t.total_ms("multiply") > 0
