"""CSR (compressed sparse row) matrix (counterpart of
cusp_autotuned_tpu/formats/csr.py; parity target cusp::csr_matrix).

col/val are padded to the reference's 128-multiple length with col == 0,
val == 0 beyond indptr[num_rows].  The expanded per-entry row ids are built
once here, padded with num_rows, so the plain SpMV is a gather and an
index_add_ with no per-call expansion.
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
class CSR(MatrixBase):
    indptr: torch.Tensor       # (num_rows + 1,) int32
    col: torch.Tensor          # (nnz_pad,) int32; padding = 0
    val: torch.Tensor          # (nnz_pad,) values; padding = 0
    row: torch.Tensor          # (nnz_pad,) int32 row ids; padding = num_rows
    shape: Tuple[int, int]
    nnz: int

    format = "csr"


def csr_matrix(indptr, col, val, shape, *, dtype=None, device=None) -> CSR:
    """Build a CSR container from host arrays on `device`, by default the
    CUDA device (utils.config.resolve_device)."""
    device = resolve_device(device)
    indptr = np.asarray(host_array(indptr), dtype=np.int32)
    col = np.asarray(host_array(col), dtype=np.int32)
    val = host_array(val)
    m, n = int(shape[0]), int(shape[1])
    if indptr.shape != (m + 1,):
        raise ValueError(f"indptr must have shape ({m + 1},), got {indptr.shape}")
    nnz = int(indptr[-1])
    if col.shape[0] < nnz or val.shape[0] < nnz:
        raise ValueError("col/val shorter than indptr[-1]")
    col, val = col[:nnz], val[:nnz]
    npad = max(LANE, round_up(nnz, LANE))
    row = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))
    return CSR(
        indptr=index_tensor(indptr, device),
        col=index_tensor(pad_to(col, npad, fill=0), device),
        val=value_tensor(pad_to(val, npad, fill=0), dtype, device),
        row=index_tensor(pad_to(row, npad, fill=m), device),
        shape=(m, n),
        nnz=nnz,
    )


def csr_from_scipy(S, dtype=None, device=None) -> CSR:
    """A scipy matrix as a CSR container on `device` (by default the CUDA
    device), its columns sorted within each row."""
    S = S.tocsr()
    S.sort_indices()
    return csr_matrix(S.indptr, S.indices, S.data, S.shape, dtype=dtype,
                      device=device)
