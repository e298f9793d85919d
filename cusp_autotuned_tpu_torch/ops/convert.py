"""Format conversion with COO as the hub format (counterpart of
cusp_autotuned_tpu/ops/convert.py; parity target cusp/convert.h and
cusp/system/detail/generic/conversions/*_to_other.h).

Conversions are set-up work: sizes depend on the data, so they run on the
host in numpy and upload the finished container to the source's device.
The DIA fill guard is the reference's: reject when the fill ratio exceeds
3.0 and the padded size exceeds 1e6 (coo_to_other.h:155-161).
"""

from __future__ import annotations

import numpy as np

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
from cusp_autotuned_tpu_torch.formats.dia import dia_matrix
from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up

MAX_FILL_RATIO = 3.0
FILL_THRESHOLD = 1e6


def coo_arrays(A):
    """(row, col, val, shape) host arrays of A's stored entries, trimmed of
    padding and sorted by (row, col)."""
    if isinstance(A, (F.COO, F.CSR)):
        nnz = A.nnz
        row = host_array(A.row[:nnz]).astype(np.int32)
        return row, host_array(A.col[:nnz]), host_array(A.val[:nnz]), A.shape
    if isinstance(A, F.DIA):
        data = host_array(A.data)
        m, n = A.shape
        i = np.arange(m)
        rows, cols, vals = [], [], []
        for d, off in enumerate(A.offsets):
            j = i + off
            valid = (j >= 0) & (j < n)
            v = data[d, :m][valid]
            keep = v != 0
            rows.append(i[valid][keep])
            cols.append(j[valid][keep])
            vals.append(v[keep])
        row = np.concatenate(rows).astype(np.int32)
        col = np.concatenate(cols).astype(np.int32)
        val = np.concatenate(vals)
        order = np.argsort(row.astype(np.int64) * (n + 1) + col, kind="stable")
        return row[order], col[order], val[order], A.shape
    raise TypeError(f"cannot extract COO triplets from {type(A)}")


def _coo_to_csr(row, col, val, shape, device):
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    return csr_matrix(np.cumsum(indptr), col, val, shape, device=device)


def _coo_to_dia(row, col, val, shape, device, *, dont_throw=False):
    m, n = shape
    delta = col.astype(np.int64) - row.astype(np.int64)
    diag_offsets = np.unique(delta)
    num_diagonals = diag_offsets.size
    size = float(num_diagonals) * float(m)
    fill_ratio = size / max(1.0, float(val.size))
    if fill_ratio > MAX_FILL_RATIO and size > FILL_THRESHOLD and not dont_throw:
        raise FormatConversionException(
            "dia_matrix fill-in would exceed maximum tolerance")
    rows_pad = max(LANE, round_up(m, LANE))
    data = np.zeros((max(1, num_diagonals), rows_pad), dtype=val.dtype)
    if num_diagonals:
        data[np.searchsorted(diag_offsets, delta), row] = val
        offsets = diag_offsets.astype(np.int32)
    else:
        offsets = np.zeros(1, dtype=np.int32)
    return dia_matrix(offsets, data, shape, nnz=int(val.size), device=device)


def convert(src, fmt: str, *, dont_throw: bool = False):
    """Convert a COO/CSR/DIA container to format `fmt` ('coo'/'csr'/'dia').
    dont_throw disables the DIA fill guard, as in the reference."""
    fmt = fmt.lower()
    if getattr(src, "format", None) == fmt:
        return src
    row, col, val, shape = coo_arrays(src)
    if fmt == "coo":
        return coo_matrix(row, col, val, shape, sort=False, device=src.device)
    if fmt == "csr":
        return _coo_to_csr(row, col, val, shape, src.device)
    if fmt == "dia":
        return _coo_to_dia(row, col, val, shape, src.device,
                           dont_throw=dont_throw)
    raise ValueError(f"unknown target format {fmt!r}")
