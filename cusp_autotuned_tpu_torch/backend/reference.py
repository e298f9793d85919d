"""NumPy/SciPy oracle (counterpart of cusp_autotuned_tpu/backend/reference.py):
a slow host-side implementation that the port's kernels and plain paths are
checked against.  It reads the port's containers only; it never calls the
JAX package."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.utils.config import resolve_device


def to_scipy(A):
    """A port container as a scipy.sparse matrix."""
    from cusp_autotuned_tpu_torch import formats as F

    if isinstance(A, F.COO):
        nnz = A.nnz
        return sp.coo_matrix((host_array(A.val[:nnz]),
                              (host_array(A.row[:nnz]), host_array(A.col[:nnz]))),
                             shape=A.shape)
    if isinstance(A, F.CSR):
        nnz = A.nnz
        return sp.csr_matrix((host_array(A.val[:nnz]), host_array(A.col[:nnz]),
                              host_array(A.indptr)), shape=A.shape)
    if isinstance(A, F.DIA):
        data = host_array(A.data)
        m, n = A.shape
        # port layout data[d, i] = A[i, i+off]; scipy's is data[d, j] = A[j-off, j]
        sdata = np.zeros((len(A.offsets), n), dtype=data.dtype)
        i = np.arange(m)
        for d, off in enumerate(A.offsets):
            j = i + off
            valid = (j >= 0) & (j < n)
            sdata[d, j[valid]] = data[d, i[valid]]
        return sp.dia_matrix((sdata, np.asarray(A.offsets)), shape=A.shape)
    if isinstance(A, (F.ELL, F.ELLR)):
        col, val = host_array(A.col), host_array(A.val)
        slot, r = np.nonzero(col != F.INVALID_INDEX)
        return sp.coo_matrix((val[slot, r], (r, col[slot, r])), shape=A.shape)
    if isinstance(A, F.HYB):
        return (to_scipy(A.ell) + to_scipy(A.coo)).tocoo()
    raise TypeError(f"cannot convert {type(A)} to scipy")


def from_scipy(S, fmt: str = "csr", dtype=None, device=None):
    """A scipy matrix as the port's `fmt` container on `device` (by default
    the CUDA device); it is assembled and converted on the host."""
    from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
    from cusp_autotuned_tpu_torch.ops.convert import convert
    device = resolve_device(device)
    S = S.tocoo()
    return convert(coo_matrix(S.row, S.col, S.data, S.shape, dtype=dtype,
                              device="cpu"), fmt).to(device)


def reference_spmv(A, x) -> np.ndarray:
    """Oracle y = A @ x via scipy, in float64."""
    return to_scipy(A).astype(np.float64) @ np.asarray(host_array(x), np.float64)


def reference_spgemm(A, B) -> sp.spmatrix:
    """Oracle C = A @ B via scipy, in float64, as a scipy COO matrix."""
    return (to_scipy(A).astype(np.float64) @ to_scipy(B).astype(np.float64)).tocoo()
