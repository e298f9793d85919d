"""Sorting building blocks (counterpart of cusp_autotuned_tpu/ops/sort.py;
parity target cusp/sort.h:38-302 — counting_sort, counting_sort_by_key,
sort_by_row, sort_by_row_and_column).

Every sort here is a stable torch.sort on the tensors' device.  The JAX
package sorts several keys at once (lax.sort with num_keys=2); torch has no
such sort, so a (row, col) order is one stable sort of the int64 key
row * num_cols + col.
"""

from __future__ import annotations

import torch


def counting_sort(keys, kmin=None, kmax=None):
    """Sorted copy of integer keys (the bounds are accepted for API parity;
    the sort does not need them)."""
    return torch.sort(torch.as_tensor(keys), stable=True).values


def counting_sort_by_key(keys, vals, kmin=None, kmax=None):
    """(sorted keys, vals in the keys' stable order)."""
    keys = torch.as_tensor(keys)
    order = torch.sort(keys, stable=True).indices
    return keys[order], torch.as_tensor(vals, device=keys.device)[order]


def sort_by_row(row, col, val):
    """Sort COO triplets by row, stable in their given order."""
    row = torch.as_tensor(row)
    order = torch.sort(row, stable=True).indices
    return row[order], torch.as_tensor(col)[order], torch.as_tensor(val)[order]


def sort_by_row_and_column(row, col, val):
    """Sort COO triplets by (row, col), stable: one sort of the int64 key
    row * num_cols + col, num_cols one past the largest column."""
    row, col = torch.as_tensor(row), torch.as_tensor(col)
    num_cols = int(col.max()) + 1 if col.numel() else 1
    order = torch.sort(row.long() * num_cols + col.long(), stable=True).indices
    return row[order], col[order], torch.as_tensor(val)[order]
