"""The band mask of the planned rails (counterpart of
cusp_autotuned_tpu/kernels/streaming.py).

A buffer that a kernel does not fully write may hold anything, NaN or Inf
bit patterns included: torch.empty does not clear memory.  Such a buffer
is zeroed where it was not written by a select, never by a 0/1 multiply,
since 0 * NaN = NaN.  The JAX module's resolve_stream is a VMEM budget of
the TPU rails and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch


def band_mask(visited_band_indices, n_bands: int, band_rows: int, dtype,
              device="cpu"):
    """(n_bands * band_rows, 1) column: 1 where a band was written, 0 else."""
    mask = np.zeros(n_bands, np.float32)
    mask[np.unique(np.asarray(visited_band_indices))] = 1
    return torch.from_numpy(np.repeat(mask, band_rows)[:, None]).to(
        device=device, dtype=dtype)


def apply_band_mask(yv, mask):
    """yv where mask is nonzero, else 0: a NaN-safe select."""
    return torch.where(mask != 0, yv, torch.zeros((), dtype=yv.dtype,
                                                  device=yv.device))
