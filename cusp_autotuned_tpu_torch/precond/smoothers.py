"""Smoother adapters: the presmooth/postsmooth interface of the multilevel
V-cycle (counterpart of cusp_autotuned_tpu/precond/smoothers.py; parity:
cusp/precond/smoother/{jacobi,polynomial}_smoother.h).  presmooth starts
from x0 = 0, so a Jacobi presmooth needs no SpMV.  The Gauss-Seidel and SOR
smoothers need the multicolour graph colouring, which is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.relaxation.jacobi import Jacobi, jacobi
from cusp_autotuned_tpu_torch.relaxation.polynomial import Polynomial, polynomial
from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException


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


def gauss_seidel_smoother(A):
    raise NotImplementedException(
        "gauss_seidel_smoother needs graph.coloring (multicolour Gauss-Seidel), "
        "which waits for the graph slice of the port")


def sor_smoother(A, omega: float = 1.0):
    raise NotImplementedException(
        "sor_smoother needs graph.coloring (multicolour SOR), which waits for "
        "the graph slice of the port")
