"""Gram-Schmidt orthogonalization (counterpart of
cusp_autotuned_tpu/eigen/gram_schmidt.py; parity target
cusp/eigen/gram_schmidt.h)."""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.formats.base import as_tensor


def gram_schmidt(V, device=None):
    """Orthonormalize the columns of V (n, k) by classical Gram-Schmidt
    with one re-orthogonalization pass, column by column.  A dependent
    column comes out zero.  V stays on its device; host data goes to
    `device`, by default the CUDA device.  Returns a row-major (n, k)
    tensor, the layout the SpMM kernels take."""
    V = as_tensor(V, device=device)
    Q = torch.zeros_like(V, memory_format=torch.contiguous_format)
    for i in range(V.shape[1]):
        v = V[:, i]
        for _ in range(2):
            v = v - Q[:, :i] @ (Q[:, :i].T @ v)
        norm = torch.linalg.vector_norm(v)
        Q[:, i] = v / torch.where(norm > 0, norm, 1)
    return Q
