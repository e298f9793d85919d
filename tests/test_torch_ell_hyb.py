"""Parity of the port's ELL, ELLR and HYB containers, conversions, plain
SpMV paths and the gallery generators with the JAX package's, on the CPU;
and the entry points' device rule."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cusp_autotuned_tpu as jct
from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import to_scipy as jax_to_scipy
from cusp_autotuned_tpu.ops.multiply import multiply as jax_multiply
from cusp_autotuned_tpu.utils.exceptions import (
    FormatConversionException as JaxFormatConversionException,
)

from cusp_autotuned_tpu_torch import formats as F, gallery, interop
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException,
)

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import example_matrices

SOURCES = {
    "poisson5pt": lambda: jgallery.poisson5pt(37, 41, format="coo", dtype=np.float32),
    "rand50x40": lambda: jct.convert(jct.backend.reference.from_scipy(
        example_matrices()["rand50x40"], "coo"), "coo"),
    "widerow": lambda: jct.backend.reference.from_scipy(
        example_matrices()["widerow"], "coo"),
    "single": lambda: jct.backend.reference.from_scipy(
        example_matrices()["single"], "coo"),
}


def _same_ell(P, J):
    """P's slot arrays equal J's on the matrix's rows; J's padding rows
    beyond them hold only sentinels."""
    m = J.shape[0]
    col, val = np.asarray(J.col), np.asarray(J.val)
    assert P.width == col.shape[0] and P.nnz == J.nnz
    np.testing.assert_array_equal(P.col.numpy(), col[:, :m])
    np.testing.assert_array_equal(P.val.numpy(), val[:, :m])
    assert (col[:, m:] == -1).all() and (val[:, m:] == 0).all()
    if J.format == "ellr":
        np.testing.assert_array_equal(P.row_lengths.numpy(),
                                      np.asarray(J.row_lengths)[:m])


def _same(P, J):
    assert P.format == J.format and P.shape == tuple(J.shape) and P.nnz == J.nnz
    if J.format in ("ell", "ellr"):
        _same_ell(P, J)
    elif J.format == "hyb":
        _same_ell(P.ell, J.ell)
        _same(P.coo, J.coo)
    else:
        for f in {"coo": ("row", "col", "val"),
                  "csr": ("indptr", "col", "val", "row")}[J.format]:
            np.testing.assert_array_equal(getattr(P, f).numpy(),
                                          np.asarray(getattr(J, f)), err_msg=f)


@pytest.mark.parametrize("fmt", ["ell", "ellr", "hyb"])
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_convert_to_ell_family_equals_jax(source, fmt):
    J = SOURCES[source]()
    P = convert(port_of(J), fmt)
    _same(P, jct.convert(J, fmt))
    np.testing.assert_array_equal(to_scipy(P).toarray(),
                                  jax_to_scipy(jct.convert(J, fmt)).toarray())


@pytest.mark.parametrize("src,dst", [
    (s, d) for s in ("ell", "ellr", "hyb")
    for d in ("coo", "csr", "dia", "hyb", "ell") if s != d])
def test_convert_from_ell_family_equals_jax(src, dst):
    J = jct.convert(SOURCES["widerow"](), src)
    _same_or_dia(convert(port_of(J), dst), jct.convert(J, dst))


def _same_or_dia(P, J):
    if J.format == "dia":
        assert P.offsets == tuple(J.offsets)
        np.testing.assert_array_equal(P.data.numpy(), np.asarray(J.data))
    else:
        _same(P, J)


def test_hyb_split_uses_the_reference_width():
    """Rows past the optimal width spill to the COO part: 9000 rows of 2
    entries, 10 of them with 38 more, give width 2 (9000 rows longer than
    1 are more than breakeven_threshold; 10 longer than 2 are fewer)."""
    rows = np.r_[np.repeat(np.arange(9000), 2), np.repeat(np.arange(10), 38)]
    cols = np.r_[np.tile([0, 1], 9000), np.tile(np.arange(2, 40), 10)]
    S = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(9000, 50))
    J = jct.convert(jct.backend.reference.from_scipy(S, "coo"), "hyb")
    P = convert(from_scipy(S, "coo", device="cpu"), "hyb")
    assert P.ell.width == J.ell.width == 2 and P.coo.nnz == J.coo.nnz == 10 * 38
    _same(P, J)


def test_ell_fill_guard_raises_in_both():
    """One 2000-entry row in a 2000-row matrix: width 2000 x 2000 rows is
    past the 3.0 fill ratio and the 1e6 threshold."""
    n = 2000
    rows = np.r_[np.zeros(n, np.int32), np.arange(1, n, dtype=np.int32)]
    cols = np.r_[np.arange(n, dtype=np.int32), np.arange(1, n, dtype=np.int32)]
    S = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n))
    with pytest.raises(FormatConversionException):
        convert(from_scipy(S, "coo", device="cpu"), "ell")
    with pytest.raises(JaxFormatConversionException):
        jct.convert(jct.backend.reference.from_scipy(S, "coo"), "ell")
    P = convert(from_scipy(S, "coo", device="cpu"), "ell", dont_throw=True)
    _same(P, jct.convert(jct.backend.reference.from_scipy(S, "coo"), "ell",
                         dont_throw=True))


@pytest.mark.parametrize("fmt", ["ell", "ellr", "hyb"])
def test_interop_round_trip(fmt):
    J = jct.convert(jgallery.poisson9pt(13, 11, format="coo", dtype=np.float32), fmt)
    P = port_of(J)
    _same(P, J)
    np.testing.assert_array_equal(to_scipy(P).toarray(), jax_to_scipy(J).toarray())


def test_ellr_row_lengths_recomputed_from_the_sentinel():
    col = np.array([[0, 1, -1], [2, -1, -1]], np.int32)
    val = np.array([[1.0, 2.0, 5.0], [3.0, 7.0, 0.0]], np.float32)
    A = F.ellr_matrix(col, val, (3, 3), device="cpu")
    assert A.row_lengths.tolist() == [2, 1, 0] and A.nnz == 3
    assert A.val[1, 1] == 0                    # values under the sentinel zeroed


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("fmt", ["ell", "ellr", "hyb"])
def test_plain_spmv_matches_jax(fmt, k):
    J = jct.convert(SOURCES["widerow"](), fmt)
    rng = np.random.RandomState(4)
    x = rng.randn(J.num_cols, k).astype(np.float32) if k else \
        rng.randn(J.num_cols).astype(np.float32)
    want = np.asarray(jax_multiply(J, x))
    got = multiply(port_of(J), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ellr_plain_path_masks_by_row_lengths():
    """Slots past row_lengths do not count even where col is valid."""
    col = np.array([[0, 1], [2, 0]], np.int32)
    val = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    A = F.ellr_matrix(col, val, (2, 3), row_lengths=[2, 1], device="cpu")
    from cusp_autotuned_tpu_torch.ops.multiply import spmv_ellr
    y = spmv_ellr(A, torch.tensor([1.0, 10.0, 100.0]))
    assert y.tolist() == [301.0, 20.0]


def test_random_and_diagonal_generators_equal_jax():
    _same(gallery.random(60, 70, 400, format="coo", device="cpu"),
          jgallery.random(60, 70, 400, format="coo"))
    _same(gallery.random(60, 70, 400, format="csr", seed=3, device="cpu"),
          jgallery.random(60, 70, 400, format="csr", seed=3))
    for P, J in [(gallery.make_diagonal_symmetric_matrix(300, 300, 3, 5, device="cpu"),
                  jgallery.make_diagonal_symmetric_matrix(300, 300, 3, 5)),
                 (gallery.make_diagonal_matrix(200, 150, [-7, 0, 9], device="cpu"),
                  jgallery.make_diagonal_matrix(200, 150, [-7, 0, 9]))]:
        _same_or_dia(P, J)
        assert P.nnz == J.nnz
    with pytest.raises(InvalidInputException):
        gallery.make_diagonal_symmetric_matrix(10, 10, 4, 7, device="cpu")


ENTRY_POINTS = {
    "poisson5pt": lambda: gallery.poisson5pt(4, 4),
    "poisson9pt": lambda: gallery.poisson9pt(4, 4),
    "stencil": lambda: gallery.generate_matrix_from_stencil([((0,), 1.0)], (5,)),
    "random": lambda: gallery.random(5, 5, 6),
    "diagonal": lambda: gallery.make_diagonal_symmetric_matrix(8, 8, 1, 3),
    "coo_matrix": lambda: F.coo_matrix([0], [0], [1.0], (2, 2)),
    "csr_matrix": lambda: F.csr_matrix([0, 1, 1], [0], [1.0], (2, 2)),
    "dia_matrix": lambda: F.dia_matrix([0], np.ones((1, 2)), (2, 2)),
    "ell_matrix": lambda: F.ell_matrix(np.zeros((1, 2), np.int32), np.ones((1, 2)), (2, 2)),
    "ellr_matrix": lambda: F.ellr_matrix(np.zeros((1, 2), np.int32), np.ones((1, 2)), (2, 2)),
    "from_scipy": lambda: from_scipy(sp.eye(3, format="coo")),
    "interop": lambda: interop.from_reference(
        "coo", {"row": [0], "col": [0], "val": [1.0]}, (2, 2), 1),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_a_gpu(monkeypatch, entry):
    """Called without a device, an entry point builds on the card; where
    torch sees none it raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidInputException, match="no CUDA device"):
        ENTRY_POINTS[entry]()
