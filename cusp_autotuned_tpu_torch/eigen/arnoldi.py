"""Arnoldi factorization (counterpart of cusp_autotuned_tpu/eigen/arnoldi.py;
parity target cusp/eigen/arnoldi.h:83: arnoldi(A, H, k=10) builds the
k-step upper Hessenberg matrix)."""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.eigen.spectral_radius import start_vector
from cusp_autotuned_tpu_torch.ops.multiply import multiply


def _arnoldi_factor(A, k: int, seed: int = 0):
    """k-step Arnoldi, classical Gram-Schmidt twice against the basis so
    far (numerically as good as modified Gram-Schmidt), on A's device with
    no host read inside the loop.  Returns host (H (m+1, m), Q (m+1, n)),
    cut at the first breakdown."""
    q = start_vector(A, seed)
    k = min(k, A.num_rows)
    Q = q.new_zeros((k + 1, q.shape[0]))
    Q[0] = q / torch.linalg.vector_norm(q)
    H = q.new_zeros((k + 1, k))
    for j in range(k):
        w = multiply(A, Q[j])
        # the rows past j are zero, so the products over all rows are exact
        h1 = Q @ w
        w = w - Q.T @ h1
        h2 = Q @ w
        w = w - Q.T @ h2
        beta = torch.linalg.vector_norm(w)
        Q[j + 1] = torch.where(beta > 1e-12, w / torch.clamp(beta, min=1e-30), 0)
        H[:, j] = h1 + h2
        H[j + 1, j] = beta
    H, Q = H.cpu().numpy(), Q.cpu().numpy()
    small = np.nonzero(np.abs(np.diag(H, -1)) < 1e-12)[0]
    m = int(small[0]) + 1 if small.size else k
    return H[: m + 1, : m], Q[: m + 1]


def arnoldi(A, k: int = 10, seed: int = 0):
    """The (m+1, m) Hessenberg H of a k-step Arnoldi factorization, on A's
    device (the functional form of the reference's arnoldi(A, H, k))."""
    H, _ = _arnoldi_factor(A, k, seed)
    return torch.from_numpy(H).to(A.device)
