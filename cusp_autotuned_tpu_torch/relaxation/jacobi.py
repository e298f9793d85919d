"""Weighted Jacobi relaxation (counterpart of
cusp_autotuned_tpu/relaxation/jacobi.py; parity: cusp::relaxation::jacobi,
cusp/relaxation/jacobi.h:95-157): x <- x + omega D^-1 (b - A x), the
diagonal extracted at set-up."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.ops.format_utils import inverse_diagonal_host
from cusp_autotuned_tpu_torch.ops.multiply import multiply


@dataclasses.dataclass(frozen=True)
class Jacobi:
    diag_inv: torch.Tensor          # D^-1, 0 where the diagonal is 0
    default_omega: float
    scaled_inv: torch.Tensor        # default_omega * D^-1, computed once
    shape: Tuple[int, int] = (0, 0)

    format = "jacobi_relaxation"

    def __call__(self, A, b, x, omega=None):
        # (omega * D^-1) * r: the JAX package's order of the products
        w = self.scaled_inv if omega is None else omega * self.diag_inv
        return x + w * (b - multiply(A, x))


def jacobi(A, omega: float = 1.0) -> Jacobi:
    dinv = torch.from_numpy(inverse_diagonal_host(A)).to(device=A.device,
                                                         dtype=A.dtype)
    # omega rounded to A's dtype first, as the JAX package stores it
    omega_t = torch.tensor(omega, dtype=A.dtype)
    return Jacobi(diag_inv=dinv, default_omega=float(omega_t),
                  scaled_inv=omega_t.to(A.device) * dinv, shape=tuple(A.shape))
