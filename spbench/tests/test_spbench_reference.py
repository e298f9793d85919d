"""The reference's stencil products and CG, and the benchmark's own
assembly, against scipy on small grids."""

import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from spbench import stencils
from spbench.reference import cg as ref_cg
from spbench.reference import stencil as ref_stencil
from spbench.tests.conftest import SMALL_GRIDS, small_config

CASES = [(name, i) for name, grids in SMALL_GRIDS.items() for i in range(len(grids))]


def scipy_matrix(spec):
    """The stencil's matrix by scipy: a sum over its points of value times
    the Kronecker product of one shift a grid axis (x fastest)."""
    grid = spec["grid"]
    m = int(np.prod(grid))
    A = sp.csr_matrix((m, m))
    for off, value in stencils.points(spec):
        K = sp.identity(1, format="csr")
        for n, d in zip(grid, off):
            K = sp.kron(sp.eye(n, k=d, format="csr"), K, format="csr")
        A = A + value * K
    scale = spec.get("diagonal_scale")
    if scale is not None:
        s = np.full(m, float(scale["other_rows"]))
        s[: len(scale["first_rows"])] = scale["first_rows"]
        A = A.tolil()
        A.setdiag(A.diagonal() * s)
    A = A.tocsr()
    A.eliminate_zeros()
    return A


def spec_of(name, i):
    return small_config(name)["matrices"][i]


@pytest.mark.parametrize("name,i", CASES)
@pytest.mark.parametrize("k", [0, 3])
def test_stencil_apply_matches_scipy(name, i, k):
    spec = spec_of(name, i)
    A = scipy_matrix(spec)
    g = torch.Generator().manual_seed(7 + i)
    x = torch.randn((A.shape[0], k) if k else (A.shape[0],), generator=g,
                    dtype=torch.float64)
    got = ref_stencil.apply(spec, x, torch.float64).numpy()
    np.testing.assert_allclose(got, A @ x.numpy(), rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("name,i", CASES)
def test_assembly_matches_scipy(name, i):
    spec = spec_of(name, i)
    A = scipy_matrix(spec)
    indptr, col, val, row, shape, nnz = stencils.csr_arrays(spec, torch.float64, "cpu")
    assert nnz == A.nnz == stencils.nnz_of(spec["grid"], stencils.points(spec))
    assert shape == A.shape
    np.testing.assert_array_equal(indptr.numpy(), A.indptr)
    np.testing.assert_array_equal(col[:nnz].numpy(), A.indices)
    np.testing.assert_array_equal(val[:nnz].numpy(), A.data)
    np.testing.assert_array_equal(row[:nnz].numpy(), np.repeat(np.arange(shape[0]),
                                                               np.diff(A.indptr)))
    assert col.shape[0] % 128 == 0 and bool((row[nnz:] == shape[0]).all())
    data, offsets, shape, nnz_d = stencils.dia_arrays(spec, torch.float64, "cpu")
    assert nnz_d == nnz and list(offsets) == sorted(offsets)
    # the port's DIA is row-indexed: data[d, i] = A[i, i + offsets[d]]
    D = np.zeros(shape)
    for d, off in enumerate(offsets):
        i = np.arange(shape[0])
        keep = (i + off >= 0) & (i + off < shape[1])
        D[i[keep], i[keep] + off] = data[d, : shape[0]].numpy()[keep]
        assert not data[d, : shape[0]].numpy()[~keep].any()
    assert not data[:, shape[0]:].any()
    np.testing.assert_array_equal(D, A.toarray())


@pytest.mark.parametrize("iterations", [1, 7, 50])
def test_cg_matches_scipy(iterations):
    spec = spec_of("cusp_laplacians", 4)
    A = scipy_matrix(spec)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    want, _ = spla.cg(A, b, x0=np.zeros_like(b), rtol=0.0, atol=0.0, maxiter=iterations)
    got, its = ref_cg.cg(lambda v: ref_stencil.apply(spec, v, torch.float64),
                         torch.from_numpy(b), iterations, torch.float64)
    assert its == iterations
    assert np.linalg.norm(got.numpy() - want) <= 1e-12 * np.linalg.norm(want)


def numpy_cg(A, b, limit, rtol):
    """CG from x0 = 0 that stops as HPCG's CG_ref does: once ||r|| <= rtol
    ||r0||, or after `limit` iterations; (x, iterations)."""
    x, r = np.zeros_like(b), b.copy()
    p, rr, k = r.copy(), r @ r, 0
    while k < limit and np.sqrt(rr) > rtol * np.linalg.norm(b):
        ap = A @ p
        alpha = rr / (p @ ap)
        x, r = x + alpha * p, r - alpha * ap
        rr, rr_old = r @ r, rr
        p = r + (rr / rr_old) * p
        k += 1
    return x, k


@pytest.mark.parametrize("seed", [1, 2])
def test_cg_stops_as_hpcg(seed):
    cfg = small_config("hpcg_testcg_256")
    (spec,) = cfg["matrices"]
    A = scipy_matrix(spec)
    scale = stencils.row_scale(spec, torch.float64, "cpu").numpy()
    b = scale * np.random.default_rng(seed).standard_normal(A.shape[0])
    want, want_its = numpy_cg(A, b, cfg["iteration_limit"], cfg["relative_tolerance"])
    got, its = ref_cg.cg(lambda v: ref_stencil.apply(spec, v, torch.float64),
                         torch.from_numpy(b), cfg["iteration_limit"], torch.float64,
                         cfg["relative_tolerance"])
    # TestCG's scaled diagonal: about ten iterations, twelve allowed
    assert its == want_its and 8 <= its <= 12
    assert np.linalg.norm(got.numpy() - want) <= 1e-12 * np.linalg.norm(want)
