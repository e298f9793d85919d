"""Permutation matrix (counterpart of
cusp_autotuned_tpu/formats/permutation.py; parity target
cusp::permutation_matrix, cusp/permutation_matrix.h:448): a row
permutation stored as one index vector.  As an operator it gathers,
y = P x = x[perm]; symmetric_rcm returns one."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import MatrixBase, host_array, index_tensor
from cusp_autotuned_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class PermutationMatrix(MatrixBase):
    perm: torch.Tensor         # (n,) int32: row i of P has its 1 in column perm[i]
    shape: Tuple[int, int]

    format = "permutation"

    @property
    def nnz(self) -> int:
        return self.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.perm.dtype

    @property
    def device(self) -> torch.device:
        return self.perm.device


def permutation_matrix(perm, *, device=None) -> PermutationMatrix:
    """P from its index vector: a tensor stays on its device unless
    `device` names another; host data lands on `device`, by default the
    CUDA device (utils.config.resolve_device)."""
    if isinstance(perm, torch.Tensor) and device is None:
        device = perm.device
    perm = np.asarray(host_array(perm))
    if perm.ndim != 1:
        raise ValueError(f"perm must be 1-D, got shape {perm.shape}")
    n = int(perm.shape[0])
    return PermutationMatrix(perm=index_tensor(perm, resolve_device(device)),
                             shape=(n, n))
