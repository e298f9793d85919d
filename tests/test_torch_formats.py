"""Parity of the PyTorch port's containers, gallery and conversions with the
JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

import cusp_autotuned_tpu as jct
from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import to_scipy as jax_to_scipy
from cusp_autotuned_tpu.formats.coo import coo_matrix as jax_coo_matrix

from cusp_autotuned_tpu_torch import gallery
from cusp_autotuned_tpu_torch.backend.reference import to_scipy, from_scipy
from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException
from cusp_autotuned_tpu.utils.exceptions import (
    FormatConversionException as JaxFormatConversionException,
)

from tests.torch_parity import FIELDS, one_thread, port_of  # noqa: F401


def _assert_same_container(P, J):
    assert P.format == J.format
    assert P.shape == tuple(J.shape) and P.nnz == J.nnz
    if J.format == "dia":
        assert P.offsets == tuple(J.offsets)
    for f in FIELDS[J.format]:
        np.testing.assert_array_equal(getattr(P, f).numpy(), np.asarray(getattr(J, f)),
                                      err_msg=f)


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
@pytest.mark.parametrize("stencil", ["poisson5pt", "poisson9pt"])
def test_gallery_arrays_equal(stencil, fmt):
    P = getattr(gallery, stencil)(37, 41, format=fmt, device="cpu")
    J = getattr(jgallery, stencil)(37, 41, format=fmt, dtype=np.float32)
    assert P.dtype == torch.float32
    _assert_same_container(P, J)


@pytest.mark.parametrize("src,dst", [("csr", "dia"), ("dia", "csr"),
                                     ("coo", "dia"), ("dia", "coo"),
                                     ("csr", "coo"), ("coo", "csr")])
def test_convert_equal(src, dst):
    P = convert(gallery.poisson5pt(37, 41, format=src, device="cpu"), dst)
    J = jct.convert(jgallery.poisson5pt(37, 41, format=src, dtype=np.float32), dst)
    _assert_same_container(P, J)


def _scattered_triplets(n, seed):
    """One entry per row in a random column: about n diagonals."""
    rng = np.random.RandomState(seed)
    return (np.arange(n, dtype=np.int32), rng.permutation(n).astype(np.int32),
            rng.uniform(1.0, 2.0, n).astype(np.float32))


def test_dia_fill_guard_raises_in_both():
    n = 2000                                       # ~1300 diagonals x 2000 rows
    row, col, val = _scattered_triplets(n, 4)
    with pytest.raises(FormatConversionException):
        convert(coo_matrix(row, col, val, (n, n), device="cpu"), "dia")
    with pytest.raises(JaxFormatConversionException):
        jct.convert(jax_coo_matrix(row, col, val, (n, n)), "dia")


def test_dia_fill_guard_dont_throw_equal():
    n = 2000
    row, col, val = _scattered_triplets(n, 4)
    P = convert(coo_matrix(row, col, val, (n, n), device="cpu"), "dia",
                dont_throw=True)
    J = jct.convert(jax_coo_matrix(row, col, val, (n, n)), "dia", dont_throw=True)
    _assert_same_container(P, J)


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_interop_round_trip(fmt):
    J = jgallery.poisson5pt(23, 19, format=fmt, dtype=np.float32)
    P = port_of(J)
    _assert_same_container(P, J)
    # and back: both oracles see one matrix
    np.testing.assert_array_equal(to_scipy(P).toarray(), jax_to_scipy(J).toarray())
    _assert_same_container(from_scipy(to_scipy(P), fmt, device="cpu"), J)


def test_to_device_moves_every_tensor():
    A = gallery.poisson5pt(5, 4, format="csr", device="cpu")
    M = A.to("meta")
    assert {t.device.type for t in (M.indptr, M.col, M.val, M.row)} == {"meta"}
    assert M.shape == A.shape and M.nnz == A.nnz
