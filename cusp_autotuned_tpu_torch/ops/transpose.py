"""Transpose of every container (counterpart of
cusp_autotuned_tpu/ops/transpose.py; parity target cusp/transpose.h and
generic/transpose.inl).

Set-up work, on the container's device: a solver transposes once (BiCG's
A^T) and applies the result in its loop.  A DIA matrix is transposed on
its device by moving each diagonal's slots; the other sparse formats go
through their sorted COO triplets on the host and `convert`, like every
conversion of the port.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up


def _transpose_dia(A):
    """A^T's diagonal -off holds A's diagonal off, re-indexed by column:
    A[i, i + off] = data[d, i] becomes A^T[j, j - off] at slot j = i + off,
    for the rows j in [max(off, 0), min(m + off, n))."""
    m, n = A.shape
    k = len(A.offsets)
    data = A.data.new_zeros((k, max(LANE, round_up(n, LANE))))
    for d, off in enumerate(A.offsets):
        lo, hi = max(off, 0), min(m + off, n)
        if hi > lo:
            data[k - 1 - d, lo:hi] = A.data[d, lo - off:hi - off]
    return F.DIA(data=data, offsets=tuple(-o for o in reversed(A.offsets)),
                 shape=(n, m), nnz=A.nnz)


def transpose(A):
    """A^T: a tensor's last two axes swapped; a sparse container in its
    own format on its own device; a permutation's inverse."""
    if isinstance(A, torch.Tensor):
        return A.transpose(-1, -2)
    if isinstance(A, F.PermutationMatrix):
        return F.permutation_matrix(torch.argsort(A.perm))   # P^T = P^-1
    if not F.is_sparse(A):
        raise TypeError(f"cannot transpose {type(A)}")
    if isinstance(A, F.DIA):
        return _transpose_dia(A)
    from cusp_autotuned_tpu_torch.ops.convert import convert, coo_arrays
    row, col, val, (m, n) = coo_arrays(A)
    At = F.coo_matrix(col, row, val, (n, m), sort=True, device=A.device)
    return convert(At, A.format)
