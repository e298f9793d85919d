"""Chebyshev polynomial relaxation (counterpart of
cusp_autotuned_tpu/relaxation/polynomial.py; parity:
cusp::relaxation::polynomial, cusp/relaxation/polynomial.h:101-178): the
cubic with Chebyshev roots on [rho/30, 1.1 rho], normalised so C(0) = 1,
rho from the port's 8-step Lanczos Ritz estimate, applied by the same
Horner recurrence in A."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.ops.multiply import multiply


def chebyshev_polynomial_coefficients(rho: float, lower_bound: float = 1.0 / 30.0,
                                      upper_bound: float = 1.1) -> np.ndarray:
    """Monic cubic with Chebyshev roots on [lower*rho, upper*rho], scaled so
    the constant term is 1 (reference: detail/polynomial.inl:40-75)."""
    degree = 3
    x0, x1 = lower_bound * rho, upper_bound * rho
    roots = [math.cos(math.pi * (i + 0.5) / degree) for i in range(degree)]
    roots = [0.5 * (x1 - x0) * (1 + r) + x0 for r in roots]
    a, b, c = roots
    coefficients = np.array([1.0, -(a + b + c), a * b + b * c + c * a,
                             -(a * b * c)])
    return coefficients / coefficients[-1]


@dataclasses.dataclass(frozen=True)
class Polynomial:
    coefficients: Tuple[float, ...]     # the residual polynomial's, in A's dtype
    shape: Tuple[int, int] = (0, 0)

    format = "polynomial_relaxation"

    def __call__(self, A, b, x, coefficients=None):
        cf = self.coefficients if coefficients is None else tuple(coefficients)
        r = b - multiply(A, x)
        h = cf[0] * r
        for c in cf[1:]:
            h = multiply(A, h) + c * r
        return x + h


def polynomial(A, coefficients=None, rho: float | None = None) -> Polynomial:
    if coefficients is None:
        if rho is None:
            from cusp_autotuned_tpu_torch.eigen.spectral_radius import (
                ritz_spectral_radius)
            rho = ritz_spectral_radius(A, 8, symmetric=True)
        cf = -chebyshev_polynomial_coefficients(float(rho))[:-1]
    else:
        cf = -np.asarray(coefficients, dtype=np.float64)[:-1]
    # rounded to the working precision, as the JAX package stores them
    np_dtype = np.float32 if "32" in str(A.dtype) else np.float64
    return Polynomial(coefficients=tuple(float(c) for c in cf.astype(np_dtype)),
                      shape=tuple(A.shape))
