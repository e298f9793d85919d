"""SOR relaxation (counterpart of cusp_autotuned_tpu/relaxation/sor.py;
parity: cusp/relaxation/sor.h:98-165): successive over-relaxation as a
weighted multicolour Gauss-Seidel sweep,

    x <- (1 - omega) x + omega GS(x).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.relaxation.gauss_seidel import FORWARD, GaussSeidel, gauss_seidel


@dataclasses.dataclass(frozen=True)
class SOR:
    gs: GaussSeidel
    default_omega: torch.Tensor     # a 0-d tensor in A's dtype, on A's device
    shape: Tuple[int, int] = (0, 0)

    format = "sor_relaxation"

    def __call__(self, A, b, x, omega=None, direction=None):
        omega = self.default_omega if omega is None else omega
        x_gs = self.gs(A, b, x, direction)
        return (1 - omega) * x + omega * x_gs


def sor(A, omega: float = 1.0, default_direction: str = FORWARD,
        seed: int = 0) -> SOR:
    gs = gauss_seidel(A, default_direction, seed)
    return SOR(gs=gs, default_omega=torch.tensor(omega, dtype=gs.diag_inv.dtype,
                                                 device=gs.diag_inv.device),
               shape=tuple(A.shape))
