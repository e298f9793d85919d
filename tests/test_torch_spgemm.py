"""The port's SpGEMM (ops/spgemm.py, multiply on sparse operands,
generalized_spgemm) against the JAX package's, on the CPU.

The cases of tests/test_ops.py on the same seeded inputs in both packages:
the format pairs of test_spgemm, the large random product, min-plus small
and at 10,000 rows, the forced multi-slice products (plain and semiring,
MAX_WORKSPACE patched small in both), permutation × sparse and dense ×
sparse.  Tolerances: f32 rtol 1e-5, atol 1e-6 (rtol 1e-4 for the large
random product, as tests/test_ops.py:60); f64 rtol 1e-10; integer-valued
products and patterns exactly.  A forced multi-slice product equals the
single-slice one, and the plan moves no O(nnz) array to the host."""

import operator

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cusp_autotuned_tpu as jct
import cusp_autotuned_tpu.ops.spgemm as JSG
from cusp_autotuned_tpu.formats.permutation import permutation_matrix as jpermutation

import cusp_autotuned_tpu_torch as ct
import cusp_autotuned_tpu_torch.ops.spgemm as SG
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu_torch.formats import permutation_matrix

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import build, example_matrices

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-10, atol=0)


def _triplets_port(C):
    nnz = C.nnz
    if C.format != "coo":
        C = ct.convert(C, "coo")
    return (C.row[:nnz].numpy(), C.col[:nnz].numpy(), C.val[:nnz].numpy())


def _triplets_jax(C):
    if C.format != "coo":
        C = jct.convert(C, "coo")
    return (np.asarray(C.row)[:C.nnz], np.asarray(C.col)[:C.nnz],
            np.asarray(C.val)[:C.nnz])


def _same(port, jax_c, tol):
    """The same pattern exactly and values within tol."""
    assert port.shape == tuple(jax_c.shape) and port.nnz == jax_c.nnz
    (pr, pc, pv), (jr, jc, jv) = _triplets_port(port), _triplets_jax(jax_c)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(pv, jv, **tol)


@pytest.mark.parametrize("fa", ["coo", "csr", "dia"])
@pytest.mark.parametrize("fb", ["coo", "csr", "ell"])
def test_spgemm_formats_match_jax(fa, fb):
    S1 = example_matrices()["rect3x5"]
    S2 = example_matrices()["rect3x5"].T.tocoo()
    JA, JB = build(S1, fa), build(S2, fb)
    C = ct.multiply(port_of(JA), port_of(JB))
    assert C.format == fa and C.device.type == "cpu"
    _same(C, jct.multiply(JA, JB), F32)
    np.testing.assert_allclose(to_scipy(C).toarray(), (S1 @ S2).toarray(), **F32)


def test_spgemm_large_random_matches_jax():
    rng = np.random.RandomState(5)
    S1 = sp.random(120, 90, density=0.05, random_state=rng).astype(np.float32)
    S2 = sp.random(90, 150, density=0.05, random_state=rng).astype(np.float32)
    JA, JB = build(S1, "csr"), build(S2, "csr")
    C = ct.multiply(port_of(JA), port_of(JB))
    _same(C, jct.multiply(JA, JB), dict(rtol=1e-4, atol=1e-6))
    np.testing.assert_allclose(to_scipy(C).toarray(), (S1 @ S2).toarray(),
                               rtol=1e-4, atol=1e-6)


def test_spgemm_bits_equal_scipy_and_repeat():
    """Integer-valued f32 products are exact: C equals scipy's bit for bit,
    and a second call gives the same bits."""
    A = ct.gallery.poisson5pt(40, 30, format="csr", device="cpu")
    S = to_scipy(A)
    C, C2 = ct.multiply(A, A), ct.multiply(A, A)
    R = (S @ S).tocsr()
    R.sort_indices()
    np.testing.assert_array_equal(C.indptr.numpy(), R.indptr)
    np.testing.assert_array_equal(C.col[:C.nnz].numpy(), R.indices)
    assert C.val[:C.nnz].numpy().tobytes() == R.data.tobytes()
    for f in ("indptr", "col", "val", "row"):
        assert torch.equal(getattr(C, f), getattr(C2, f))
    assert ct.is_valid_matrix(C)
    # the padding follows the COO convention
    assert (C.row[C.nnz:] == C.num_rows).all() and (C.val[C.nnz:] == 0).all()


def _min_plus_oracle(S1, S2):
    acc = {}
    S1c, S2c = S1.tocoo(), S2.tocsr()
    for r, c1, v in zip(S1c.row, S1c.col, S1c.data):
        lo, hi = S2c.indptr[c1], S2c.indptr[c1 + 1]
        for c2, v2 in zip(S2c.indices[lo:hi], S2c.data[lo:hi]):
            t = v + v2
            acc[(r, c2)] = min(acc[(r, c2)], t) if (r, c2) in acc else t
    return acc


def test_generalized_spgemm_min_plus_small():
    S = example_matrices()["small4x4"]
    JA = build(S, "coo")
    C = ct.generalized_spgemm(port_of(JA), port_of(JA), None,
                              lambda a, b: a + b, min)
    _same(C, jct.generalized_spgemm(JA, JA, None, lambda a, b: a + b, min), F32)
    got = {(int(r), int(c)): float(v) for r, c, v in zip(*_triplets_port(C))}
    assert got == pytest.approx(_min_plus_oracle(S, S))


def min_plus_10k(seed=5, n=10_000, density=3e-4):
    """tests/test_ops.py:266's recipe, a 10,000-row f64 matrix of density
    3e-4 plus I, drawn by numpy index draws (scipy's sp.random visits every
    one of the 10^8 cells: ~9 s)."""
    rng = np.random.RandomState(seed)
    k = int(density * n * n)
    S = sp.coo_matrix((rng.rand(k), (rng.randint(0, n, k), rng.randint(0, n, k))),
                      shape=(n, n)) + sp.eye(n)
    return S.tocsr().astype(np.float64)


def test_generalized_spgemm_min_plus_10k():
    JA = build(min_plus_10k().tocoo(), "coo")
    C = ct.generalized_spgemm(port_of(JA), port_of(JA), None,
                              lambda a, b: a + b, min)
    _same(C, jct.generalized_spgemm(JA, JA, None, lambda a, b: a + b, min), F64)


def _random_pair(seed, density, shape=(120, 90, 110), integer=False):
    rng = np.random.RandomState(seed)
    m, k, n = shape
    S1 = sp.random(m, k, density=density, random_state=rng).tocsr()
    S2 = sp.random(k, n, density=density, random_state=rng).tocsr()
    if integer:
        S1.data = np.ceil(8 * S1.data)
        S2.data = np.ceil(8 * S2.data)
    return S1, S2


@pytest.mark.parametrize("semiring", [False, True])
def test_spgemm_multi_slice_matches_jax_and_single_slice(monkeypatch, semiring):
    """The port's MAX_WORKSPACE patched small, as tests/test_ops.py:321 and
    :360 patch the JAX package's (8192 here: four slices): the sliced
    product equals the JAX package's product and the port's single-slice
    one bit for bit (integer values).  The JAX side runs unsliced: each of
    its slices is a compile of its own, and tests/test_ops.py holds its
    sliced path to the same oracles."""
    S1, S2 = _random_pair(77 if not semiring else 78, 0.15, integer=True)
    JA, JB = build(S1.tocoo(), "coo"), build(S2.tocoo(), "coo")
    A, B = port_of(JA), port_of(JB)
    ops = dict(combine=np.add, reduce=np.minimum) if semiring else {}
    single = SG.spgemm(A, B, **ops)
    monkeypatch.setattr(SG, "MAX_WORKSPACE", 8192)
    assert len(SG.plan(A, B).bounds) > 2
    C = SG.spgemm(A, B, **ops)
    _same(C, JSG.spgemm(JA, JB, **ops), F64)
    for f in ("row", "col", "val"):
        assert torch.equal(getattr(C, f), getattr(single, f))
    if semiring:
        got = {(int(r), int(c)): float(v) for r, c, v in zip(*_triplets_port(C))}
        assert got == _min_plus_oracle(S1, S2)
    else:
        np.testing.assert_array_equal(to_scipy(C).toarray(), (S1 @ S2).toarray())


def test_spgemm_multi_slice_random_floats(monkeypatch):
    """Random f64 values, the port sliced at 512: within 1e-10 of the JAX
    package's product and of scipy."""
    S1, S2 = _random_pair(21, 0.08, shape=(80, 60, 90))
    JA, JB = build(S1.tocoo(), "coo"), build(S2.tocoo(), "coo")
    monkeypatch.setattr(SG, "MAX_WORKSPACE", 512)
    C = SG.spgemm(port_of(JA), port_of(JB))
    assert C.nnz and len(SG.plan(port_of(JA), port_of(JB)).bounds) > 5
    _same(C, JSG.spgemm(JA, JB), F64)
    np.testing.assert_allclose(to_scipy(C).toarray(), (S1 @ S2).toarray(), **F64)


def test_spgemm_plan_moves_no_nnz_array_to_the_host(monkeypatch):
    """Only scalars cross to the host while a sliced product runs: no
    tensor of more than O(num_rows) elements is read back."""
    S1, S2 = _random_pair(77, 0.15)
    A = from_scipy(S1, "coo", device="cpu")
    B = from_scipy(S2, "csr", device="cpu")
    monkeypatch.setattr(SG, "MAX_WORKSPACE", 512)
    limit = max(S1.shape + S2.shape) + 1
    pulls = []
    for name in ("numpy", "tolist", "cpu"):
        real = getattr(torch.Tensor, name)

        def guarded(self, *args, _real=real, **kw):
            if self.numel() > limit:
                pulls.append(tuple(self.shape))
            return _real(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, guarded)
    C = SG.spgemm(A, B)
    monkeypatch.undo()
    assert not pulls, pulls
    np.testing.assert_allclose(to_scipy(C).toarray(), (S1 @ S2).toarray(), **F64)


@pytest.mark.parametrize("side", ["left", "right", "both"])
def test_permutation_products_match_jax(side):
    S = example_matrices()["rand50x40"].T.tocoo() @ example_matrices()["rand50x40"]
    S = sp.coo_matrix(S)
    n = S.shape[0]
    perm = np.random.RandomState(3).permutation(n).astype(np.int32)
    JA, JP = build(S, "csr"), jpermutation(perm)
    A, P = port_of(JA), permutation_matrix(perm, device="cpu")
    jl, jr = {"left": (JP, JA), "right": (JA, JP), "both": (JP, JP)}[side]
    pl, pr = {"left": (P, A), "right": (A, P), "both": (P, P)}[side]
    C = ct.multiply(pl, pr)
    _same(C, jct.multiply(jl, jr), F32)
    Sp = sp.coo_matrix((np.ones(n), (np.arange(n), perm)), shape=(n, n))
    sl, sr = {"left": (Sp, S), "right": (S, Sp), "both": (Sp, Sp)}[side]
    np.testing.assert_allclose(to_scipy(C).toarray(), (sl @ sr).toarray(), **F32)


@pytest.mark.parametrize("fmt", ["csr", "coo", "dia"])
@pytest.mark.parametrize("k", [None, 3])
def test_dense_times_sparse_matches_jax(fmt, k):
    S = example_matrices()["rand50x40"]
    JB = build(S, fmt)
    rng = np.random.RandomState(4)
    X = rng.randn(S.shape[0]).astype(np.float32) if k is None else \
        rng.randn(k, S.shape[0]).astype(np.float32)
    y = ct.multiply(torch.as_tensor(X), port_of(JB))
    np.testing.assert_allclose(y.numpy(), np.asarray(jct.multiply(X, JB)), **F32)
    np.testing.assert_allclose(y.numpy(), X @ S.toarray(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_spgemm_dtypes_match_jax(dtype):
    rng = np.random.RandomState(11)
    S1 = sp.random(30, 25, density=0.2, random_state=rng).astype(dtype)
    S2 = sp.random(25, 35, density=0.2, random_state=rng).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        S1.data = S1.data + 1j * rng.randn(S1.nnz)
        S2.data = S2.data - 1j * rng.randn(S2.nnz)
    JA, JB = build(S1.tocoo(), "csr"), build(S2.tocoo(), "coo")
    C = ct.multiply(port_of(JA), port_of(JB))
    assert C.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    _same(C, jct.multiply(JA, JB), F64)


@pytest.mark.parametrize("reduce,combine", [(max, operator.mul), (operator.mul, operator.add),
                                            (lambda a, b: torch.maximum(a, b), operator.sub)])
def test_generalized_spgemm_reduces(reduce, combine):
    """Builtin and custom reduces: max, mul and a function of two tensors
    (ops.segment.segment_reduce's scan), against a dict oracle."""
    S1, S2 = _random_pair(5, 0.1, shape=(20, 15, 25), integer=True)
    A, B = from_scipy(S1, "csr", device="cpu"), from_scipy(S2, "csr", device="cpu")
    C = ct.generalized_spgemm(A, B, None, combine, reduce)
    red = {max: max, operator.mul: operator.mul}.get(reduce, max)
    acc = {}
    S2c = S2.tocsr()
    for r, c1, v in zip(S1.tocoo().row, S1.tocoo().col, S1.tocoo().data):
        for c2, v2 in zip(S2c.indices[S2c.indptr[c1]:S2c.indptr[c1 + 1]],
                          S2c.data[S2c.indptr[c1]:S2c.indptr[c1 + 1]]):
            t = combine(v, v2)
            acc[(r, c2)] = red(acc[(r, c2)], t) if (r, c2) in acc else t
    got = {(int(r), int(c)): float(v) for r, c, v in zip(*_triplets_port(C))}
    assert got == pytest.approx(acc)


def test_spgemm_empty_and_mismatch():
    A = from_scipy(sp.coo_matrix((6, 7), dtype=np.float32), "csr", device="cpu")
    B = from_scipy(sp.random(7, 4, density=0.3, random_state=1), "coo", device="cpu")
    C = ct.multiply(A, B)
    assert C.format == "csr" and C.nnz == 0 and C.shape == (6, 4)
    with pytest.raises(ct.InvalidInputException):
        ct.multiply(B, B)
