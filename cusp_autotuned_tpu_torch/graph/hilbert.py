"""Hilbert space-filling-curve partitioning (counterpart of
cusp_autotuned_tpu/graph/hilbert.py).

Parity: cusp::graph::hilbert_curve(coord, num_parts, parts): each 2-D or
3-D point goes to one of num_parts contiguous chunks of the Hilbert order.
Skilling's transform, vectorised over the points in numpy on the host (a
set-up op, as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.utils.config import resolve_device

BITS = 16


def _axes_to_hilbert(X: np.ndarray, bits: int) -> np.ndarray:
    """Skilling's AxesToTranspose and a bit interleave; X is (npts, ndim)
    unsigned."""
    X = X.astype(np.uint64).copy()
    npts, ndim = X.shape
    M = np.uint64(1 << (bits - 1))

    # inverse undo
    Q = M
    while Q > np.uint64(1):
        P = Q - np.uint64(1)
        for i in range(ndim):
            hit = (X[:, i] & Q) != 0
            X[hit, 0] ^= P
            t = (X[~hit, 0] ^ X[~hit, i]) & P
            X[~hit, 0] ^= t
            X[~hit, i] ^= t
        Q >>= np.uint64(1)

    # Gray encode
    for i in range(1, ndim):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(npts, np.uint64)
    Q = M
    while Q > np.uint64(1):
        hit = (X[:, ndim - 1] & Q) != 0
        t[hit] ^= Q - np.uint64(1)
        Q >>= np.uint64(1)
    for i in range(ndim):
        X[:, i] ^= t

    # interleave the bits, most significant first
    h = np.zeros(npts, np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(ndim):
            h = (h << np.uint64(1)) | ((X[:, i] >> np.uint64(b)) & np.uint64(1))
    return h


def hilbert_curve(coord, num_parts: int, *, device=None) -> torch.Tensor:
    """coord: (n_points, 2 or 3) coordinates.  Returns the int32 part of
    each point, num_parts balanced contiguous chunks of the Hilbert order,
    on coord's device where coord is a tensor, else on `device` (by default
    the CUDA device, utils.config.resolve_device)."""
    if isinstance(coord, torch.Tensor) and device is None:
        device = coord.device
    device = resolve_device(device)
    coord = np.asarray(host_array(coord), np.float64)
    if coord.ndim != 2 or coord.shape[1] not in (2, 3):
        raise ValueError("coord must be (n_points, 2 or 3)")
    n = coord.shape[0]
    lo = coord.min(axis=0)
    span = np.maximum(coord.max(axis=0) - lo, 1e-300)
    quant = ((coord - lo) / span * ((1 << BITS) - 1)).astype(np.uint64)
    order = np.argsort(_axes_to_hilbert(quant, BITS), kind="stable")
    parts = np.empty(n, np.int32)
    parts[order] = (np.arange(n) * num_parts) // n
    return torch.from_numpy(parts).to(device)
