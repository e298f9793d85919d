"""Tentative prolongator from aggregates and a near-nullspace candidate
(counterpart of cusp_autotuned_tpu/precond/aggregation/tentative.py;
parity: cusp::precond::aggregation::fit_candidates,
cusp/precond/aggregation/detail/tentative.inl): T has one column per
aggregate holding the normalised restriction of B; returns (T, B_coarse).
One candidate vector (the reference's default B = ones)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cusp_autotuned_tpu_torch.precond.aggregation.structured_rap import (
    container_from_csr,
)


def fit_candidates(aggregates, B, dtype=None, device=None):
    """aggregates: (n,) int aggregate id per row (-1 = unaggregated);
    B: (n,) host candidate.  Returns (T, B_coarse): T a CSR container of
    torch `dtype` (B's by default) on `device` (by default the CUDA
    device), B_coarse the aggregates' norms as a host array."""
    import torch
    agg = np.asarray(aggregates).astype(np.int64)
    B_np = np.asarray(B)
    b = B_np.astype(np.float64)
    n = agg.shape[0]
    n_agg = int(agg.max()) + 1 if agg.size else 0

    norms_sq = np.zeros(n_agg)
    valid = agg >= 0
    np.add.at(norms_sq, agg[valid], b[valid] ** 2)
    norms = np.sqrt(norms_sq)
    safe = np.where(norms > 0, norms, 1.0)

    rows = np.nonzero(valid)[0]
    cols = agg[valid]
    vals = b[valid] / safe[cols]
    out_dt = B_np.dtype if np.issubdtype(B_np.dtype, np.floating) else np.dtype(np.float64)
    T = sp.csr_matrix((vals.astype(out_dt), (rows, cols)), shape=(n, n_agg))
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, out_dt)).dtype
    return container_from_csr(T, dtype, device), norms.astype(out_dt)
