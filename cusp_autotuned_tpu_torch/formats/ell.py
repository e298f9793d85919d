"""ELL / ELLR (ELLPACK) sparse matrices (counterpart of
cusp_autotuned_tpu/formats/ell.py; parity targets cusp::ell_matrix and the
fork's cusp::ktt::ellr_matrix, ELL plus an explicit per-row length array).

Slot-major layout (width, rows): slot s of row i is col[s, i], val[s, i],
so the loads of neighbouring rows are neighbouring addresses.  Invalid
slots keep the reference's col == -1 sentinel with val == 0.  The JAX
package pads the row axis to the TPU's 128-wide lane; the port does not,
and no kernel here asks for it.
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

INVALID_INDEX = -1


@dataclasses.dataclass(frozen=True)
class ELL(MatrixBase):
    col: torch.Tensor          # (width, rows) int32; invalid = -1
    val: torch.Tensor          # (width, rows) values; invalid = 0
    shape: Tuple[int, int]
    nnz: int

    format = "ell"

    @property
    def width(self) -> int:
        """Max entries per row (cusp num_entries_per_row)."""
        return self.col.shape[0]


@dataclasses.dataclass(frozen=True)
class ELLR(MatrixBase):
    col: torch.Tensor          # (width, rows) int32; invalid = -1
    val: torch.Tensor          # (width, rows) values
    row_lengths: torch.Tensor  # (rows,) int32
    shape: Tuple[int, int]
    nnz: int

    format = "ellr"

    width = ELL.width


def _slots(col, val, shape):
    """Host slot arrays cut to (width, rows), with val zeroed where col is
    the sentinel, and the count of valid slots."""
    col = np.asarray(host_array(col), dtype=np.int32)
    val = host_array(val)
    m, n = int(shape[0]), int(shape[1])
    if col.shape != val.shape or col.ndim != 2 or col.shape[1] < m:
        raise ValueError("col/val must be equal-shape (width, rows) arrays")
    col, val = col[:, :m], val[:, :m]
    val = np.where(col == INVALID_INDEX, 0, val).astype(val.dtype)
    return col, val, (m, n), int(np.count_nonzero(col != INVALID_INDEX))


def ell_matrix(col, val, shape, *, dtype=None, device=None) -> ELL:
    """Build from slot-major (width, rows) arrays with -1 marking padding,
    on `device` (by default the CUDA device)."""
    device = resolve_device(device)
    col, val, shape, nnz = _slots(col, val, shape)
    return ELL(col=index_tensor(col, device), val=value_tensor(val, dtype, device),
               shape=shape, nnz=nnz)


def ellr_matrix(col, val, shape, *, row_lengths=None, dtype=None,
                device=None) -> ELLR:
    """ELL plus per-row lengths; the lengths are recomputed from the
    sentinel when not given (parity: ellr_matrix::update_row_lengths)."""
    device = resolve_device(device)
    col, val, shape, nnz = _slots(col, val, shape)
    if row_lengths is None:
        row_lengths = np.sum(col != INVALID_INDEX, axis=0)
    row_lengths = np.asarray(host_array(row_lengths))[: shape[0]]
    return ELLR(col=index_tensor(col, device), val=value_tensor(val, dtype, device),
                row_lengths=index_tensor(row_lengths, device), shape=shape,
                nnz=nnz)
