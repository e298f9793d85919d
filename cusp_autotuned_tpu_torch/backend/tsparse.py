"""The vendor-library baseline: torch.sparse, which runs cuSPARSE on the
card (counterpart of cusp_autotuned_tpu/backend/jsparse.py, whose library
is jax.experimental.sparse's BCOO).

Parity: the reference's cusparse adapter
(cusp/system/cuda/detail/cusparse/cusparse_spmv.h:72), a library baseline
that sits next to the native kernels and shares their verbs.  This is not a
port of any Pallas kernel: `cusparse_spmv` is registered as the explicit
`impl="cusparse"` (kernels/variants.py), where the JAX package has
`impl="bcoo"`, and kept out of every tuning walk, the default
configuration and the cost model.  It is a baseline, not a contender.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch import formats as F

LAYOUTS = ("csr", "coo")


def _entries(A):
    """(row, col, val) tensors of A's stored entries on A's device, without
    padding (ELL's -1 slots included), sorted by (row, col)."""
    if isinstance(A, (F.COO, F.CSR)):
        return A.row[:A.nnz], A.col[:A.nnz], A.val[:A.nnz]
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, val, _ = coo_arrays(A)
    return (torch.as_tensor(row, device=A.device),
            torch.as_tensor(col, device=A.device),
            torch.as_tensor(val, device=A.device))


def to_torch_sparse(A, layout: str = "csr"):
    """Any sparse container as a torch.sparse_csr_tensor (layout 'csr') or
    a coalesced torch.sparse_coo_tensor ('coo') on A's device, with int32
    indices (int64 for COO, torch's only index type there), sorted and
    unique: repeated (row, col) entries are summed, explicit zeros kept
    (the counterpart of to_bcoo).  A CSR container's sorted arrays are
    used as they are."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}; one of {LAYOUTS}")
    row, col, val = _entries(A)
    m, n = A.shape
    key = row.long() * n + col.long()
    canonical = key.numel() < 2 or bool((key[1:] > key[:-1]).all())
    if not canonical:
        key, inverse = torch.unique(key, sorted=True, return_inverse=True)
        val = val.new_zeros(key.numel()).index_add_(0, inverse, val)
        row, col = (key // n).int(), (key % n).int()
    if layout == "coo":
        return torch.sparse_coo_tensor(torch.stack([row.long(), col.long()]), val,
                                       (m, n), is_coalesced=True)
    if isinstance(A, F.CSR) and canonical:
        indptr = A.indptr
    else:
        indptr = torch.zeros(m + 1, dtype=torch.int32, device=val.device)
        indptr[1:] = torch.cumsum(torch.bincount(row.long(), minlength=m), 0)
    return torch.sparse_csr_tensor(indptr, col.int(), val, size=(m, n))


def from_torch_sparse(M, format: str = "coo"):
    """A torch sparse tensor (CSR or COO) as the port's container in
    `format`, on M's device (the counterpart of from_bcoo)."""
    from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
    from cusp_autotuned_tpu_torch.ops.convert import convert
    if M.layout == torch.sparse_csr:
        M = M.to_sparse_coo()
    M = M.coalesce()
    row, col = M.indices().cpu().numpy()
    C = coo_matrix(row, col, M.values().cpu(), tuple(M.shape), device=M.device)
    return C if format == "coo" else convert(C, format)


def cusparse_spmv(A):
    """fn(x) -> A @ x through the library (torch.sparse CSR times a vector
    or a dense block (n, k): cuSPARSE on the card), x promoted with A's
    values as the port's impls promote it."""
    M = to_torch_sparse(A, "csr")
    by_dtype = {M.dtype: M}

    def fn(x):
        dtype = torch.promote_types(M.dtype, x.dtype)
        S = by_dtype.get(dtype)
        if S is None:
            S = by_dtype[dtype] = M.to(dtype)
        return S @ x.to(dtype)
    return fn
