"""Random sparse matrices (counterpart of cusp_autotuned_tpu/gallery/random.py;
parity: cusp/gallery/random.h, num_samples draws with duplicates removed,
seeded from the dimensions for reproducibility)."""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.utils.config import resolve_device


def random(m, n, num_samples, format="coo", dtype=torch.float32, seed=None,
           device=None):
    """The same draws as the JAX package's gallery.random for one seed,
    on `device` (by default the CUDA device)."""
    device = resolve_device(device)
    rng = np.random.RandomState((m ^ n ^ num_samples) & 0x7fffffff
                                if seed is None else seed)
    row = rng.randint(0, m, size=num_samples).astype(np.int32)
    col = rng.randint(0, n, size=num_samples).astype(np.int32)
    _, first = np.unique(row.astype(np.int64) * n + col, return_index=True)
    first.sort()
    row, col = row[first], col[first]
    A = coo_matrix(row, col, np.ones(row.size), (m, n), dtype=dtype,
                   device="cpu")
    return (A if format == "coo" else convert(A, format)).to(device)
