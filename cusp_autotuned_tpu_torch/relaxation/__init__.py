"""Relaxation methods (counterpart of cusp_autotuned_tpu/relaxation; parity:
cusp/relaxation/): weighted Jacobi and the Chebyshev polynomial.  Their
set-up reads the matrix on the host once; a sweep is a few PyTorch ops and
one SpMV on the device.  Multicolour Gauss-Seidel and SOR need the graph
colouring, which is not ported yet."""

from cusp_autotuned_tpu_torch.relaxation.jacobi import Jacobi, jacobi
from cusp_autotuned_tpu_torch.relaxation.polynomial import Polynomial, polynomial
