"""Prolongator smoothing and the Galerkin product (counterpart of
cusp_autotuned_tpu/precond/aggregation/smooth.py; parity:
cusp/precond/aggregation/system/detail/generic/smooth_prolongator.h:52-151,
P = (I - (omega/rho) D^-1 S) T, and detail/galerkin_product.inl,
A_c = R A P).  Both are set-up work on the host in scipy, as in the JAX
package; the results are CSR containers on the operands' device."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cusp_autotuned_tpu_torch.backend.reference import to_scipy
from cusp_autotuned_tpu_torch.precond.aggregation.structured_rap import (
    container_from_csr,
)


def smooth_prolongator(S, T, omega: float = 4.0 / 3.0,
                       rho_DinvA: float | None = None):
    """One damped-Jacobi sweep applied to the tentative prolongator T."""
    if rho_DinvA is None:
        from cusp_autotuned_tpu_torch.precond.aggregation.strength import rho_Dinv_A
        rho_DinvA = rho_Dinv_A(S)
    Ssp = to_scipy(S).tocsr().astype(np.float64)
    Tsp = to_scipy(T).tocsr().astype(np.float64)
    d = Ssp.diagonal()
    d = np.where(d != 0, d, 1.0)
    scale = omega / max(rho_DinvA, 1e-30)
    P = Tsp - scale * (sp.diags(1.0 / d) @ Ssp @ Tsp)
    return container_from_csr(P, T.dtype, T.device)


def galerkin_product(R, A, P):
    """A_c = R A P, on the host."""
    Rs = to_scipy(R).tocsr()
    As = to_scipy(A).tocsr()
    Ps = to_scipy(P).tocsr()
    return container_from_csr(Rs @ (As @ Ps), A.dtype, A.device)
