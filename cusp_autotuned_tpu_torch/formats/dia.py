"""DIA (diagonal) sparse matrix (counterpart of
cusp_autotuned_tpu/formats/dia.py; parity target cusp::dia_matrix).

data has shape (num_diags, rows_pad) with data[d, i] = A[i, i + offsets[d]]
when that slot lies inside the matrix, else 0.  rows_pad is the reference's
128-multiple row count.  The offsets are a tuple of Python ints, sorted
ascending: the kernel builders copy them to the device once per plan.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import (
    MatrixBase, host_array, value_tensor,
)
from cusp_autotuned_tpu_torch.utils.config import resolve_device
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up


@dataclasses.dataclass(frozen=True)
class DIA(MatrixBase):
    data: torch.Tensor              # (num_diags, rows_pad) values
    offsets: Tuple[int, ...]        # sorted ascending
    shape: Tuple[int, int]
    nnz: int

    format = "dia"

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def num_diagonals(self) -> int:
        return self.data.shape[0]

    @property
    def rows_padded(self) -> int:
        return self.data.shape[1]


def dia_matrix(offsets, data, shape, *, nnz=None, dtype=None,
               device=None) -> DIA:
    """Build from explicit diagonals. data[d, i] = A[i, i + offsets[d]].
    It lands on `device`, by default the CUDA device."""
    device = resolve_device(device)
    offsets = np.asarray(offsets, dtype=np.int32)
    data = host_array(data)
    m, n = int(shape[0]), int(shape[1])
    k = int(offsets.shape[0])
    if data.shape[0] != k:
        raise ValueError("data must have one row per diagonal offset")
    rows_pad = max(LANE, round_up(m, LANE))
    if data.shape[1] < rows_pad:
        buf = np.zeros((k, rows_pad), dtype=data.dtype)
        buf[:, : data.shape[1]] = data
        data = buf
    # zero out-of-matrix slots so padded rows never contribute
    i = np.arange(data.shape[1])
    j = i[None, :] + offsets[:, None]
    valid = (i[None, :] < m) & (j >= 0) & (j < n)
    data = np.where(valid, data, 0).astype(data.dtype)
    if nnz is None:
        nnz = int(np.count_nonzero(valid))
    return DIA(
        data=value_tensor(data, dtype, device),
        offsets=tuple(int(o) for o in offsets),
        shape=(m, n),
        nnz=int(nnz),
    )
