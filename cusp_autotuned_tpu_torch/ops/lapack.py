"""Dense LAPACK verbs (counterpart of cusp_autotuned_tpu/ops/lapack.py;
parity target cusp/lapack/lapack.h:44-358 — getrf potrf sytrf getrs potrs
sytrs gesv trtrs trtri syev stev stsv gesvd).

On the operands' device through torch.linalg, except the symmetric
indefinite (Bunch-Kaufman) pair sytrf/sytrs and the tridiagonal stev/stsv,
which run on the host in scipy, as the JAX package runs sytrf, sytrs and
stev (the reference binds host LAPACK for them too,
cusp/lapack/detail/stubs.h).  A non-tensor operand is taken onto the CUDA
device unless the call names another.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.utils.config import resolve_device


def _t(a, device=None):
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.asarray(a), device=resolve_device(device))


def _as_columns(b):
    """b as a 2-D right-hand side, and whether it was a vector."""
    return (b[:, None], True) if b.dim() == 1 else (b, False)


def getrf(A):
    """LU factorization with partial pivoting -> (LU, pivots); the pivots
    are LAPACK's 1-based row swaps (the JAX package's lu_factor counts from
    0)."""
    return torch.linalg.lu_factor(_t(A))


def getrs(lu_piv, b):
    LU, piv = lu_piv
    rhs, vector = _as_columns(_t(b, LU.device).to(LU.dtype))
    x = torch.linalg.lu_solve(LU, piv, rhs)
    return x[:, 0] if vector else x


def gesv(A, b):
    """Solve A x = b via LU."""
    return getrs(getrf(A), b)


def potrf(A, lower=True):
    """The Cholesky factor (lower, or upper with lower=False)."""
    return torch.linalg.cholesky(_t(A), upper=not lower)


def potrs(L, b, lower=True):
    rhs, vector = _as_columns(_t(b, L.device).to(L.dtype))
    x = torch.cholesky_solve(rhs, L, upper=not lower)
    return x[:, 0] if vector else x


_SYTRF = {np.dtype(np.float32): "s", np.dtype(np.float64): "d",
          np.dtype(np.complex64): "c", np.dtype(np.complex128): "z"}


def sytrf(A):
    """Symmetric indefinite Bunch-Kaufman factorization on the host (scipy's
    LAPACK ?sytrf, lower).  Returns an opaque factor for sytrs:
    ("bk", ldu, ipiv, dtype, device)."""
    import scipy.linalg.lapack as lp
    device = A.device if isinstance(A, torch.Tensor) else resolve_device()
    Ah = np.asarray(host_array(A))
    ldu, ipiv, info = getattr(lp, _SYTRF[Ah.dtype] + "sytrf")(Ah, lower=1)
    if info != 0:
        raise np.linalg.LinAlgError(f"sytrf failed: info={info}")
    return ("bk", ldu, ipiv, Ah.dtype, device)


def sytrs(fact, b):
    """Solve with sytrf's factor (on the host), or with getrf's (LU,
    pivots)."""
    if isinstance(fact, tuple) and len(fact) == 5 and fact[0] == "bk":
        import scipy.linalg.lapack as lp
        _, ldu, ipiv, dtype, device = fact
        x, info = getattr(lp, _SYTRF[dtype] + "sytrs")(
            ldu, ipiv, np.asarray(host_array(b)), lower=1)
        if info != 0:
            raise np.linalg.LinAlgError(f"sytrs failed: info={info}")
        return torch.as_tensor(x, device=device)
    return getrs(fact, b)


def trtrs(A, b, lower=False, unit_diagonal=False):
    A = _t(A)
    rhs, vector = _as_columns(_t(b, A.device).to(A.dtype))
    x = torch.linalg.solve_triangular(A, rhs, upper=not lower,
                                      unitriangular=unit_diagonal)
    return x[:, 0] if vector else x


def trtri(A, lower=False):
    A = _t(A)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(A, eye, upper=not lower)


def syev(A):
    """Symmetric eigendecomposition -> (eigenvalues, eigenvectors)."""
    return torch.linalg.eigh(_t(A))


def _tridiagonal_device(alphas, device):
    if device is not None:
        return resolve_device(device)
    return alphas.device if isinstance(alphas, torch.Tensor) else resolve_device()


def stev(alphas, betas, device=None):
    """Eigendecomposition of the symmetric tridiagonal matrix with diagonal
    alphas and off-diagonal betas, on the host (scipy), returned on the
    alphas' device -> (eigenvalues, eigenvectors)."""
    import scipy.linalg as sla
    out = _tridiagonal_device(alphas, device)
    w, v = sla.eigh_tridiagonal(np.asarray(host_array(alphas)),
                                np.asarray(host_array(betas)))
    return torch.as_tensor(w, device=out), torch.as_tensor(v, device=out)


def stsv(alphas, betas, b, device=None):
    """Solve the symmetric tridiagonal system (diagonal alphas, off-diagonal
    betas) for b, a vector or columns, in O(n) on the host (scipy's banded
    solve), returned on the alphas' device."""
    import scipy.linalg as sla
    out = _tridiagonal_device(alphas, device)
    a = np.asarray(host_array(alphas))
    e = np.asarray(host_array(betas))
    ab = np.zeros((3, a.size), dtype=np.result_type(a, e))
    ab[0, 1:], ab[1], ab[2, :-1] = e, a, e
    x = sla.solve_banded((1, 1), ab, np.asarray(host_array(b)).astype(ab.dtype))
    return torch.as_tensor(x, device=out)


def gesvd(A):
    """Thin SVD -> (U, S, Vh)."""
    return torch.linalg.svd(_t(A), full_matrices=False)
