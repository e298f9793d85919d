"""HYB (hybrid ELL + COO) sparse matrix (counterpart of
cusp_autotuned_tpu/formats/hyb.py; parity target cusp::hyb_matrix, whose
SpMV is an ELL pass then a COO pass)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.formats.base import MatrixBase
from cusp_autotuned_tpu_torch.formats.coo import COO
from cusp_autotuned_tpu_torch.formats.ell import ELL


@dataclasses.dataclass(frozen=True)
class HYB(MatrixBase):
    ell: ELL
    coo: COO
    shape: Tuple[int, int]

    format = "hyb"

    @property
    def nnz(self) -> int:
        return self.ell.nnz + self.coo.nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.val.dtype

    @property
    def device(self) -> torch.device:
        return self.ell.val.device

    def to(self, device) -> "HYB":
        return HYB(ell=self.ell.to(device), coo=self.coo.to(device),
                   shape=self.shape)


def hyb_matrix(ell: ELL, coo: COO) -> HYB:
    if ell.shape != coo.shape:
        raise ValueError("ELL and COO parts must agree on shape")
    if ell.device != coo.device:
        raise ValueError("ELL and COO parts must lie on one device")
    return HYB(ell=ell, coo=coo, shape=ell.shape)
