"""Relaxation methods (counterpart of cusp_autotuned_tpu/relaxation; parity:
cusp/relaxation/): weighted Jacobi, multicolour Gauss-Seidel, SOR and the
Chebyshev polynomial.  Their set-up reads the matrix on the host once (the
colouring runs on its device); a sweep is a few PyTorch ops and one SpMV on
the device, one SpMV a colour for Gauss-Seidel and SOR."""

from cusp_autotuned_tpu_torch.relaxation.jacobi import Jacobi, jacobi
from cusp_autotuned_tpu_torch.relaxation.gauss_seidel import (
    BACKWARD, FORWARD, SYMMETRIC, GaussSeidel, gauss_seidel,
)
from cusp_autotuned_tpu_torch.relaxation.sor import SOR, sor
from cusp_autotuned_tpu_torch.relaxation.polynomial import Polynomial, polynomial
