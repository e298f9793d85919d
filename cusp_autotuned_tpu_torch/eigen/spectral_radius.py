"""Spectral radius estimators (counterpart of
cusp_autotuned_tpu/eigen/spectral_radius.py; parity target
cusp/eigen/spectral_radius.h:79): Gershgorin disks, the largest Ritz value
of a k-step Lanczos (symmetric) or Arnoldi factorization, and the power
method.  AMG's prolongator smoothing and polynomial relaxation read them.

The Lanczos and Arnoldi loops run on the host and never wait for the
device inside: the basis, the coefficients and the breakdown test stay on
the device until the factorization is read back once at the end.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from cusp_autotuned_tpu_torch.ops.multiply import multiply


def work_dtype(A) -> torch.dtype:
    """The eigensolvers' working precision for A, as the JAX package picks
    it: f32 for a 32-bit matrix, else f64."""
    return torch.float32 if "32" in str(A.dtype) else torch.float64


def start_vector(A, seed, v0=None, device=None):
    """The seeded uniform start vector of the JAX package (numpy's
    RandomState(seed).rand(n) in the working precision), or v0, on A's
    device."""
    dtype = work_dtype(A)
    if isinstance(v0, torch.Tensor):
        return v0.to(dtype)
    if v0 is None:
        v0 = np.random.RandomState(seed).rand(A.num_rows)
    v0 = np.asarray(v0, np.float32 if dtype == torch.float32 else np.float64)
    return torch.from_numpy(v0).to(device or A.device)


def disks_spectral_radius(A) -> float:
    """Gershgorin bound: the largest row sum of |a_ij| (set-up work, on the
    host from A's stored entries)."""
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, _, val, (m, _) = coo_arrays(A)
    sums = np.bincount(row, weights=np.abs(val.astype(np.float64)), minlength=m)
    return float(sums.max()) if m else 0.0


def ritz_spectral_radius(A, k: int = 10, symmetric: bool = True,
                         seed: int = 0) -> float:
    """The largest |Ritz value| of a k-step Lanczos (symmetric) or Arnoldi
    factorization."""
    if symmetric:
        alphas, betas, _ = _lanczos_tridiag(A, k, seed)
        m = len(alphas)
        if m == 0:
            return 0.0
        w = sla.eigh_tridiagonal(alphas, betas[:m - 1], eigvals_only=True)
        return float(np.max(np.abs(w)))
    from cusp_autotuned_tpu_torch.eigen.arnoldi import _arnoldi_factor
    H, _ = _arnoldi_factor(A, k, seed)
    m = H.shape[1]
    return float(np.max(np.abs(np.linalg.eigvals(H[:m, :m]))))


def estimate_spectral_radius(A, k: int = 20, seed: int = 0) -> float:
    """Power-method estimate after k iterations."""
    x = start_vector(A, seed)
    for _ in range(k):
        y = multiply(A, x)
        x = y / torch.clamp(torch.linalg.vector_norm(y), min=1e-30)
    y = multiply(A, x)
    return float(torch.linalg.vector_norm(y)
                 / torch.clamp(torch.linalg.vector_norm(x), min=1e-30))


def _lanczos_tridiag(A, k: int, seed: int = 0, v0=None):
    """k-step Lanczos with full reorthogonalization.  Returns (alphas,
    betas, V) as host arrays (alphas m, betas m, V (m+1, n)), cut at the
    first breakdown (beta < 1e-12) as the reference's sequential loop
    stops."""
    v = start_vector(A, seed, v0)
    k = min(k, A.num_rows)
    V = v.new_zeros((k + 1, v.shape[0]))
    V[0] = v / torch.linalg.vector_norm(v)
    alphas, betas = v.new_zeros(k), v.new_zeros(k)
    for j in range(k):
        v = V[j]
        w = multiply(A, v)
        alpha = torch.dot(v, w)
        w = w - alpha * v
        # full reorthogonalization against the basis so far (the rows past
        # j are zero, so the product over all rows is exact)
        w = w - V.T @ (V @ w)
        beta = torch.linalg.vector_norm(w)
        V[j + 1] = torch.where(beta > 1e-12, w / torch.clamp(beta, min=1e-30), 0)
        alphas[j], betas[j] = alpha, beta
    alphas, betas = alphas.cpu().numpy(), betas.cpu().numpy()
    small = np.nonzero(betas < 1e-12)[0]
    m = int(small[0]) + 1 if small.size else k
    return alphas[:m], betas[:m], V[:m + 1].cpu().numpy()
