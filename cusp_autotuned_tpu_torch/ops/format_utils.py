"""Format utilities (counterpart of cusp_autotuned_tpu/ops/format_utils.py;
parity target cusp/format_utils.h): offsets_to_indices (:41),
indices_to_offsets (:90), the main diagonal (:140), which the relaxations
and preconditioners read at set-up, count_diagonals (:191) and the ELL/HYB
width heuristics (generic/format_utils.inl:281-320,
detail/functional.inl:114-132).

The index<->offset transforms run on their tensor's device; the planning
heuristics run on the host in numpy, as conversions do.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array


def offsets_to_indices(offsets: torch.Tensor, num_entries: int) -> torch.Tensor:
    """Expand CSR row offsets to per-entry row indices (int32) on the
    offsets' device.  Padding entries (positions >= offsets[-1]) map to
    num_rows, out of range for the row reductions."""
    positions = torch.arange(num_entries, dtype=offsets.dtype,
                             device=offsets.device)
    return (torch.searchsorted(offsets, positions, right=True) - 1).int()


def indices_to_offsets(indices: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Compress sorted per-entry row indices to CSR offsets (int32) on the
    indices' device.  Out-of-range (padding) indices are dropped."""
    slot = indices.long() + 1
    keep = (slot >= 0) & (slot <= num_rows)
    counts = torch.zeros(num_rows + 1, dtype=torch.int64, device=indices.device)
    counts.index_add_(0, slot[keep], torch.ones_like(slot[keep]))
    return torch.cumsum(counts, 0).int()


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


# -- host planning ----------------------------------------------------------

def count_diagonals(num_rows: int, num_cols: int, row_indices,
                    column_indices) -> int:
    """Number of occupied diagonals (parity: cusp/format_utils.h:191)."""
    row = np.asarray(host_array(row_indices), np.int64)
    col = np.asarray(host_array(column_indices), np.int64)
    return int(np.unique(col - row).size)


def compute_max_entries_per_row(row_offsets) -> int:
    """The longest row of a CSR offsets vector."""
    ro = np.asarray(host_array(row_offsets))
    if ro.size <= 1:
        return 0
    return int(np.max(np.diff(ro)))


def compute_optimal_entries_per_row(row_offsets, relative_speed: float = 3.0,
                                    breakeven_threshold: int = 4096) -> int:
    """ELL width for the HYB split: the smallest K such that the rows
    longer than K are rare (fewer than num_rows / relative_speed) or few
    (fewer than breakeven_threshold) (parity:
    generic/format_utils.inl:313-317, functional.inl:128-131)."""
    lengths = np.diff(np.asarray(host_array(row_offsets)))
    num_rows = lengths.size
    if num_rows == 0:
        return 0
    cumulative = np.cumsum(np.bincount(lengths))
    for K, rows_below in enumerate(cumulative):
        longer = num_rows - int(rows_below)
        if relative_speed * longer < num_rows or longer < breakeven_threshold:
            return K
    return int(lengths.max())
