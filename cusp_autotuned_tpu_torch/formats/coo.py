"""COO (coordinate) sparse matrix (counterpart of
cusp_autotuned_tpu/formats/coo.py; parity target cusp::coo_matrix).

Entries are sorted by (row, col).  The arrays are padded to the reference's
128-multiple length; padding entries carry row == num_rows (out of range,
so row reductions drop them), col == 0 and val == 0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import (
    MatrixBase, host_array, index_tensor, value_tensor,
)
from cusp_autotuned_tpu_torch.utils.config import resolve_device
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up, pad_to


@dataclasses.dataclass(frozen=True)
class COO(MatrixBase):
    row: torch.Tensor          # (nnz_pad,) int32; padding = num_rows
    col: torch.Tensor          # (nnz_pad,) int32; padding = 0
    val: torch.Tensor          # (nnz_pad,) values; padding = 0
    shape: Tuple[int, int]
    nnz: int

    format = "coo"


def coo_matrix(row, col, val, shape, *, sort: bool = True, dtype=None,
               device=None, sum_duplicates: bool = False) -> COO:
    """Build a COO container from host arrays: sort by row then column and
    pad to the reference's lane-aligned length.  It lands on `device`, by
    default the CUDA device (utils.config.resolve_device).

    sum_duplicates=True merges repeated (i, j) triplets by addition, the
    unordered-assembly idiom (reference:
    examples/MatrixAssembly/unordered_triplets.cu, sort + reduce_by_key).
    Requires sort=True."""
    device = resolve_device(device)
    row = np.asarray(host_array(row), dtype=np.int32)
    col = np.asarray(host_array(col), dtype=np.int32)
    val = host_array(val)
    if not (row.shape == col.shape == val.shape) or row.ndim != 1:
        raise ValueError("row/col/val must be equal-length 1-D arrays")
    nnz = int(row.shape[0])
    m, n = int(shape[0]), int(shape[1])
    if sort and nnz > 1:
        key = row.astype(np.int64) * (n + 1) + col
        order = np.argsort(key, kind="stable")
        row, col, val = row[order], col[order], val[order]
        if sum_duplicates:
            key = key[order]
            starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            if starts.size < nnz:
                val = np.add.reduceat(val, starts)
                row, col = row[starts], col[starts]
                nnz = int(starts.size)
    elif sum_duplicates and nnz > 1:
        raise ValueError("sum_duplicates requires sort=True")
    npad = max(LANE, round_up(nnz, LANE))
    return COO(
        row=index_tensor(pad_to(row, npad, fill=m), device),
        col=index_tensor(pad_to(col, npad, fill=0), device),
        val=value_tensor(pad_to(val, npad, fill=0), dtype, device),
        shape=(m, n),
        nnz=nnz,
    )


def coo_from_scipy(S, dtype=None, device=None) -> COO:
    """A scipy matrix as a COO container on `device` (by default the CUDA
    device)."""
    S = S.tocoo()
    return coo_matrix(S.row, S.col, S.data, S.shape, dtype=dtype, device=device)
