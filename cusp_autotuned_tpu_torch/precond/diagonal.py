"""Diagonal (Jacobi) preconditioner, M = diag(A)^-1 (counterpart of
cusp_autotuned_tpu/precond/diagonal.py; parity: cusp/precond/diagonal.h:85-107)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.ops.format_utils import inverse_diagonal_host


@dataclasses.dataclass(frozen=True)
class DiagonalPreconditioner:
    diag_inv: torch.Tensor
    shape: Tuple[int, int] = (0, 0)

    format = "diagonal_preconditioner"

    def __call__(self, x):
        return self.diag_inv * x


def diagonal(A) -> DiagonalPreconditioner:
    dinv = torch.from_numpy(inverse_diagonal_host(A)).to(device=A.device,
                                                         dtype=A.dtype)
    return DiagonalPreconditioner(diag_inv=dinv, shape=tuple(A.shape))
