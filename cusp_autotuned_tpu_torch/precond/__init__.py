"""Preconditioners (counterpart of cusp_autotuned_tpu/precond; parity:
cusp/precond/): the diagonal preconditioner, the AINV family, the smoother
adapters and smoothed-aggregation AMG."""

from cusp_autotuned_tpu_torch.precond.diagonal import DiagonalPreconditioner, diagonal
from cusp_autotuned_tpu_torch.precond.ainv import (
    AINVOperator, bridson_ainv, nonsym_bridson_ainv, scaled_bridson_ainv,
)
from cusp_autotuned_tpu_torch.precond.smoothers import (
    GaussSeidelSmoother, JacobiSmoother, PolynomialSmoother, SORSmoother,
)
from cusp_autotuned_tpu_torch.precond.multilevel import Multilevel
from cusp_autotuned_tpu_torch.precond.aggregation import smoothed_aggregation
