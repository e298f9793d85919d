"""MatrixMarket I/O (counterpart of cusp_autotuned_tpu/io/matrix_market.py;
parity target cusp/io/matrix_market.h — real, integer, complex, pattern,
general and symmetric .mtx, for files and streams), through scipy.io's
parser and writer on the host, as in the JAX package."""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu_torch.formats.base import host_array


def torch_dtype(dtype):
    """A numpy or torch dtype as a torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def as_scipy_coo(A):
    """A container, tensor or array as the scipy COO that the JAX package's
    writers write, entry for entry: a CSR's and a DIA's entries in scipy's
    order for their format, every other container's sorted by (row, col)."""
    if isinstance(A, (np.ndarray, torch.Tensor)):
        return sp.coo_matrix(host_array(A))
    if getattr(A, "format", None) in ("csr", "dia"):
        return to_scipy(A).tocoo()
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, val, shape = coo_arrays(A)
    return sp.coo_matrix((val, (row, col)), shape=shape)


def read_matrix_market_file(path, format: str = "coo", dtype=None, device=None):
    return read_matrix_market_stream(str(path), format, dtype, device)


def read_matrix_market_stream(stream, format: str = "coo", dtype=None,
                              device=None):
    mat = scipy.io.mmread(stream)
    if not sp.issparse(mat):
        mat = sp.coo_matrix(mat)
    return from_scipy(mat, format, dtype=torch_dtype(dtype), device=device)


def write_matrix_market_file(A, path, comment: str = "") -> None:
    scipy.io.mmwrite(str(path), as_scipy_coo(A), comment=comment)


def write_matrix_market_stream(A, stream, comment: str = "") -> None:
    scipy.io.mmwrite(stream, as_scipy_coo(A), comment=comment)
