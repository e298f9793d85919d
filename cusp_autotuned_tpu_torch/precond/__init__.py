"""Preconditioners (counterpart of cusp_autotuned_tpu/precond; parity:
cusp/precond/): the diagonal preconditioner, the smoother adapters and
smoothed-aggregation AMG.  The AINV family is not ported yet."""

from cusp_autotuned_tpu_torch.precond.diagonal import DiagonalPreconditioner, diagonal
from cusp_autotuned_tpu_torch.precond.smoothers import JacobiSmoother, PolynomialSmoother
from cusp_autotuned_tpu_torch.precond.multilevel import Multilevel
from cusp_autotuned_tpu_torch.precond.aggregation import smoothed_aggregation
