"""Format conversion with COO as the hub format (counterpart of
cusp_autotuned_tpu/ops/convert.py; parity target cusp/convert.h and
cusp/system/detail/generic/conversions/*_to_other.h).

Conversions are set-up work: sizes depend on the data, so they run on the
host in numpy and upload the finished container to the source's device.
The reference's planning rules hold:
  - DIA fill guard: reject when the fill ratio exceeds 3.0 and the padded
    size exceeds 1e6 (coo_to_other.h:155-161), unless dont_throw;
  - ELL width = the longest row, under the same fill guard
    (coo_to_other.h:230-252);
  - HYB split at the ELL width of compute_optimal_entries_per_row
    (relative_speed 3.0, breakeven_threshold 4096; coo_to_other.h:295-318).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.formats.base import as_tensor, host_array
from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
from cusp_autotuned_tpu_torch.formats.dia import dia_matrix
from cusp_autotuned_tpu_torch.formats.ell import (
    INVALID_INDEX, ell_matrix, ellr_matrix,
)
from cusp_autotuned_tpu_torch.formats.hyb import hyb_matrix
from cusp_autotuned_tpu_torch.ops.format_utils import compute_optimal_entries_per_row
from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up

MAX_FILL_RATIO = 3.0
FILL_THRESHOLD = 1e6


def _sorted(row, col, val, shape):
    order = np.argsort(row.astype(np.int64) * (shape[1] + 1) + col, kind="stable")
    return row[order], col[order], val[order], shape


def coo_arrays(A):
    """(row, col, val, shape) host arrays of A's stored entries, trimmed of
    padding (ELL's -1 slots included) and sorted by (row, col) as the
    reference sorts them."""
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
        return _sorted(np.concatenate(rows).astype(np.int32),
                       np.concatenate(cols).astype(np.int32),
                       np.concatenate(vals), A.shape)
    if isinstance(A, (F.ELL, F.ELLR)):
        col2, val2 = host_array(A.col), host_array(A.val)
        slot, r = np.nonzero(col2 != INVALID_INDEX)
        return _sorted(r.astype(np.int32), col2[slot, r].astype(np.int32),
                       val2[slot, r], A.shape)
    if isinstance(A, F.HYB):
        r1, c1, v1, _ = coo_arrays(A.ell)
        r2, c2, v2, _ = coo_arrays(A.coo)
        return _sorted(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                       np.concatenate([v1, v2]), A.shape)
    raise TypeError(f"cannot extract COO triplets from {type(A)}")


def _indptr(row, m):
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    return np.cumsum(indptr)


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


def _coo_to_slots(row, col, val, shape, width):
    """Scatter row-sorted triplets into slot-major (width, rows) arrays, and
    return the entries past `width` in their row (the spill)."""
    m = shape[0]
    slot = np.arange(row.size) - _indptr(row, m)[row]
    in_ell = slot < width
    cols2 = np.full((max(1, width), m), INVALID_INDEX, dtype=np.int32)
    vals2 = np.zeros((max(1, width), m), dtype=val.dtype)
    cols2[slot[in_ell], row[in_ell]] = col[in_ell]
    vals2[slot[in_ell], row[in_ell]] = val[in_ell]
    spill = ~in_ell
    return cols2, vals2, (row[spill], col[spill], val[spill])


def _ell_width(row, val, shape, num_entries_per_row, dont_throw):
    m = shape[0]
    if num_entries_per_row or not row.size:
        return int(num_entries_per_row)
    width = int(np.bincount(row, minlength=m).max())
    size = float(width) * float(m)
    if (size / max(1.0, float(val.size)) > MAX_FILL_RATIO
            and size > FILL_THRESHOLD and not dont_throw):
        raise FormatConversionException(
            "ell_matrix fill-in would exceed maximum tolerance")
    return width


def convert(src, fmt: str, *, dont_throw: bool = False,
            num_entries_per_row: int = 0):
    """Convert a container to format `fmt` ('coo'/'csr'/'dia'/'ell'/'ellr'/
    'hyb') on the source's device.  dont_throw disables the fill guards and
    num_entries_per_row fixes the ELL/HYB width, as in the reference."""
    fmt = fmt.lower()
    if getattr(src, "format", None) == fmt:
        return src
    row, col, val, shape = coo_arrays(src)
    device = src.device
    if fmt == "coo":
        return coo_matrix(row, col, val, shape, sort=False, device=device)
    if fmt == "csr":
        return csr_matrix(_indptr(row, shape[0]), col, val, shape, device=device)
    if fmt == "dia":
        return _coo_to_dia(row, col, val, shape, device, dont_throw=dont_throw)
    if fmt in ("ell", "ellr"):
        width = _ell_width(row, val, shape, num_entries_per_row, dont_throw)
        cols2, vals2, (spilled, _, _) = _coo_to_slots(row, col, val, shape, width)
        if spilled.size:
            raise FormatConversionException(
                "ell_matrix num_entries_per_row too small for this matrix")
        build = ell_matrix if fmt == "ell" else ellr_matrix
        return build(cols2, vals2, shape, device=device)
    if fmt == "hyb":
        width = num_entries_per_row
        if not width and row.size:
            width = compute_optimal_entries_per_row(_indptr(row, shape[0]))
        cols2, vals2, (sr, sc, sv) = _coo_to_slots(row, col, val, shape,
                                                   int(width))
        return hyb_matrix(ell_matrix(cols2, vals2, shape, device=device),
                          coo_matrix(sr, sc, sv, shape, device=device))
    raise ValueError(f"unknown target format {fmt!r}")


def copy(src):
    """A deep copy of a container: the same format, every tensor cloned on
    its device (parity: cusp::copy, cusp/copy.h:39,84)."""
    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return copy(v)
        return v
    return dataclasses.replace(src, **{f.name: clone(getattr(src, f.name))
                                       for f in dataclasses.fields(src) if f.init})


def to_dense(A):
    """A container (or a tensor or array) as a dense 2-D tensor on its
    device; repeated entries are summed, as the JAX package's to_dense does.
    Host data goes to the CUDA device (utils.config.resolve_device)."""
    if isinstance(A, F.Array2d):
        return A.to_dense()
    if isinstance(A, (np.ndarray, torch.Tensor)):
        return as_tensor(A)
    row, col, val, shape = coo_arrays(A)
    dense = np.zeros(shape, dtype=val.dtype)
    np.add.at(dense, (row, col), val)
    return torch.as_tensor(dense, device=A.device)
