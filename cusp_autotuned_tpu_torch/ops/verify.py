"""Structural validation (counterpart of cusp_autotuned_tpu/ops/verify.py;
parity target cusp/verify.h — is_valid_matrix :43,57,
assert_is_valid_matrix :68, assert_same_dimensions :82-122).  The checks
read the container's arrays on the host."""

from __future__ import annotations

import numpy as np

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException


def is_valid_matrix(A, output=None) -> bool:
    """Check A's structural invariants; where they fail, write the reasons
    to `output` (a file-like) when one is given."""
    msgs = []
    ok = _validate(A, msgs)
    if not ok and output is not None:
        output.write("\n".join(msgs) + "\n")
    return ok


def assert_is_valid_matrix(A) -> None:
    msgs = []
    if not _validate(A, msgs):
        raise InvalidInputException("; ".join(msgs))


def assert_same_dimensions(A, B) -> None:
    if tuple(A.shape) != tuple(B.shape):
        raise InvalidInputException(
            f"dimension mismatch: {tuple(A.shape)} vs {tuple(B.shape)}")


def _validate(A, msgs) -> bool:
    m, n = A.shape
    if isinstance(A, F.COO):
        row = host_array(A.row)[:A.nnz]
        col = host_array(A.col)[:A.nnz]
        if row.size and (row.min() < 0 or row.max() >= m):
            msgs.append("coo: row indices out of range")
        elif col.size and (col.min() < 0 or col.max() >= n):
            msgs.append("coo: column indices out of range")
        elif row.size and np.any(row[:-1] > row[1:]):
            msgs.append("coo: row indices not sorted")
        pad = host_array(A.row)[A.nnz:]
        if pad.size and np.any(pad != m):
            msgs.append("coo: padding rows must equal num_rows")
    elif isinstance(A, F.CSR):
        indptr = host_array(A.indptr)
        col = host_array(A.col)[:A.nnz]
        if indptr.shape[0] != m + 1:
            msgs.append("csr: row_offsets has wrong length")
        elif indptr[0] != 0:
            msgs.append("csr: first offset must be zero")
        elif np.any(np.diff(indptr) < 0):
            msgs.append("csr: offsets must be non-decreasing")
        elif int(indptr[-1]) != A.nnz:
            msgs.append("csr: last offset must equal num_entries")
        elif col.size and (col.min() < 0 or col.max() >= n):
            msgs.append("csr: column indices out of range")
    elif isinstance(A, F.DIA):
        offsets = np.asarray(A.offsets)
        if offsets.size > 1 and np.any(np.diff(offsets) <= 0):
            msgs.append("dia: diagonal offsets must be strictly increasing")
        if A.data.shape[0] != offsets.size:
            msgs.append("dia: data/offsets mismatch")
    elif isinstance(A, (F.ELL, F.ELLR)):
        col = host_array(A.col)
        valid = col != F.INVALID_INDEX
        if valid.any() and (col[valid].min() < 0 or col[valid].max() >= n):
            msgs.append("ell: column indices out of range")
        if col[:, m:].size and np.any(col[:, m:] != F.INVALID_INDEX):
            msgs.append("ell: padding rows must be invalid")
        if isinstance(A, F.ELLR):
            rl = host_array(A.row_lengths)
            if np.any(rl != valid.sum(axis=0)[:rl.size]):
                msgs.append("ellr: row_lengths inconsistent with pattern")
    elif isinstance(A, F.HYB):
        return _validate(A.ell, msgs) and _validate(A.coo, msgs)
    elif isinstance(A, F.PermutationMatrix):
        perm = host_array(A.perm)
        if np.any(np.sort(perm) != np.arange(m)):
            msgs.append("permutation: not a permutation of 0..n-1")
    else:
        msgs.append(f"unknown matrix type {type(A)}")
    return not msgs
