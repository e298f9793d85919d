"""Smoother adapters: the presmooth/postsmooth interface of the multilevel
V-cycle (counterpart of cusp_autotuned_tpu/precond/smoothers.py; parity:
cusp/precond/smoother/{jacobi,gauss_seidel,sor,polynomial}_smoother.h).
presmooth starts from x0 = 0, so a Jacobi presmooth needs no SpMV.
Gauss-Seidel presmooths forward and postsmooths backward; SOR sweeps in
its default direction both times."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.relaxation.gauss_seidel import (
    BACKWARD, FORWARD, GaussSeidel, gauss_seidel,
)
from cusp_autotuned_tpu_torch.relaxation.jacobi import Jacobi, jacobi
from cusp_autotuned_tpu_torch.relaxation.polynomial import Polynomial, polynomial
from cusp_autotuned_tpu_torch.relaxation.sor import SOR, sor


@dataclasses.dataclass(frozen=True)
class JacobiSmoother:
    relax: Jacobi
    shape: Tuple[int, int] = (0, 0)

    format = "jacobi_smoother"

    def presmooth(self, A, b):
        return self.relax.scaled_inv * b          # x0 = 0: omega D^-1 b

    def postsmooth(self, A, b, x):
        return self.relax(A, b, x)


@dataclasses.dataclass(frozen=True)
class GaussSeidelSmoother:
    relax: GaussSeidel
    shape: Tuple[int, int] = (0, 0)

    format = "gauss_seidel_smoother"

    def presmooth(self, A, b):
        return self.relax(A, b, torch.zeros_like(b), FORWARD)

    def postsmooth(self, A, b, x):
        return self.relax(A, b, x, BACKWARD)


@dataclasses.dataclass(frozen=True)
class SORSmoother:
    relax: SOR
    shape: Tuple[int, int] = (0, 0)

    format = "sor_smoother"

    def presmooth(self, A, b):
        return self.relax(A, b, torch.zeros_like(b))

    def postsmooth(self, A, b, x):
        return self.relax(A, b, x)


@dataclasses.dataclass(frozen=True)
class PolynomialSmoother:
    relax: Polynomial
    shape: Tuple[int, int] = (0, 0)

    format = "polynomial_smoother"

    def presmooth(self, A, b):
        return self.relax(A, b, torch.zeros_like(b))

    def postsmooth(self, A, b, x):
        return self.relax(A, b, x)


def jacobi_smoother(A, rho_DinvA: float | None = None) -> JacobiSmoother:
    """Weighted Jacobi with the SA default omega = (4/3) / rho(D^-1 A)."""
    if rho_DinvA is None:
        from cusp_autotuned_tpu_torch.precond.aggregation.strength import rho_Dinv_A
        rho_DinvA = rho_Dinv_A(A)
    omega = (4.0 / 3.0) / max(rho_DinvA, 1e-30)
    return JacobiSmoother(relax=jacobi(A, omega=omega), shape=tuple(A.shape))


def polynomial_smoother(A) -> PolynomialSmoother:
    return PolynomialSmoother(relax=polynomial(A), shape=tuple(A.shape))


def gauss_seidel_smoother(A) -> GaussSeidelSmoother:
    return GaussSeidelSmoother(relax=gauss_seidel(A), shape=tuple(A.shape))


def sor_smoother(A, omega: float = 1.0) -> SORSmoother:
    return SORSmoother(relax=sor(A, omega), shape=tuple(A.shape))
