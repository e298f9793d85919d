"""Stencil-based matrix generation on regular grids (counterpart of
cusp_autotuned_tpu/gallery/stencil.py; parity target
cusp::gallery::generate_matrix_from_stencil).  The first grid dimension
varies fastest in the linear index, as in the reference."""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.utils.config import resolve_device


def generate_matrix_from_stencil(stencil, grid, format: str = "csr",
                                 dtype: torch.dtype = torch.float32,
                                 device=None):
    """stencil: iterable of (offset_tuple, value); grid: dim sizes tuple.
    Returns the N×N operator (N = prod(grid)) with out-of-grid neighbours
    dropped (Dirichlet truncation).  The matrix is assembled and converted
    on the host and uploaded to `device` once (by default the CUDA
    device)."""
    device = resolve_device(device)
    grid = tuple(int(g) for g in grid)
    ndim = len(grid)
    N = int(np.prod(grid))
    idx = np.arange(N, dtype=np.int64)

    coords = []
    rem = idx
    for g in grid:
        coords.append(rem % g)
        rem = rem // g
    strides = np.cumprod((1,) + grid[:-1]).astype(np.int64)

    rows, cols, vals = [], [], []
    for offset, value in stencil:
        offset = tuple(int(o) for o in offset)
        if len(offset) != ndim:
            raise ValueError("stencil offset rank must match grid rank")
        valid = np.ones(N, dtype=bool)
        shift = 0
        for d in range(ndim):
            x = coords[d] + offset[d]
            valid &= (x >= 0) & (x < grid[d])
            shift += offset[d] * strides[d]
        r = idx[valid]
        rows.append(r)
        cols.append(r + shift)
        vals.append(np.full(r.size, value, dtype=np.float64))

    row = np.concatenate(rows).astype(np.int32)
    col = np.concatenate(cols).astype(np.int32)
    val = np.concatenate(vals)
    A = coo_matrix(row, col, val, (N, N), sort=True, dtype=dtype, device="cpu")
    return (A if format == "coo" else convert(A, format)).to(device)
