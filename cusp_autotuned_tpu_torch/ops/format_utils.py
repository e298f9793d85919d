"""Format utilities (counterpart of cusp_autotuned_tpu/ops/format_utils.py;
parity target cusp/format_utils.h): the main diagonal, which the
relaxations and preconditioners read at set-up."""

from __future__ import annotations

import numpy as np
import torch


def diagonal_host(A) -> np.ndarray:
    """The main diagonal of A (length min(m, n)) as a host numpy vector,
    from its stored entries (a duplicate entry's last value wins, as in the
    JAX package)."""
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, val, (m, n) = coo_arrays(A)
    on = row == col
    d = np.zeros(min(m, n), np.asarray(val).dtype)
    d[row[on]] = val[on]
    return d


def extract_diagonal(A) -> torch.Tensor:
    """The main diagonal of A as a tensor on A's device."""
    return torch.from_numpy(diagonal_host(A)).to(device=A.device, dtype=A.dtype)


def inverse_diagonal_host(A) -> np.ndarray:
    """1 / diag(A) on the host, 0 where the diagonal is 0 (the Jacobi and
    diagonal preconditioners' D^-1)."""
    d = diagonal_host(A)
    return np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0).astype(d.dtype)
