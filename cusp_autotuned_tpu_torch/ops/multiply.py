"""multiply — SpMV / SpMM / SpGEMM / operator apply (counterpart of
cusp_autotuned_tpu/ops/multiply.py; parity target cusp/multiply.h and the
format-specialised SpMV of cusp/system/detail/generic/multiply/spmv.h).

The per-format functions here are the plain PyTorch paths, for x of shape
(n,) or (n, k), on any device.  The hand-written kernels are reached
through kernels.variants.build_spmv, operators.planned_operator and the
autotuner.  generalized_spmv, the semiring product that the graph
algorithms reduce to, and the sparse × sparse products (ops/spgemm.py)
are plain PyTorch too: the JAX package computes them outside any Pallas
kernel.
"""

from __future__ import annotations

import operator

import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
from cusp_autotuned_tpu_torch.kernels.dia import dia_spmv_plain, promoted
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException


def spmv_coo(A: F.COO, x):
    return csr_spmv_plain(A.row, A.col, A.val, x, A.num_rows)


def spmv_csr(A: F.CSR, x):
    return csr_spmv_plain(A.row, A.col, A.val, x, A.num_rows)


def spmv_dia(A: F.DIA, x):
    return dia_spmv_plain(A.data, A.offsets, x, A.shape)


def _ell_terms(A, x):
    """(width, rows[, k]) products of every slot; a -1 slot gathers x[0]
    and carries val == 0, so it adds nothing.  Computed in the promoted
    type of val and x."""
    x = promoted(A.val, x)
    col = A.col.clamp(0, max(A.num_cols - 1, 0))
    xg = torch.index_select(x, 0, col.reshape(-1)).reshape(col.shape + x.shape[1:])
    val = A.val.to(x.dtype)
    return val * xg if x.dim() == 1 else val[..., None] * xg


def spmv_ell(A, x):
    return _ell_terms(A, x).sum(0)


def spmv_ellr(A, x):
    """ELLR semantics: slots past a row's length are masked by
    row_lengths, not by the sentinel (the fork's ELLR kernel rail)."""
    live = (torch.arange(A.width, device=A.col.device)[:, None]
            < A.row_lengths[None, :])
    terms = _ell_terms(A, x)
    if x.dim() == 2:
        live = live[..., None]
    return torch.where(live, terms, 0).sum(0)


def spmv_hyb(A: F.HYB, x):
    return spmv_ell(A.ell, x) + spmv_coo(A.coo, x)


def spmv_permutation(A: F.PermutationMatrix, x):
    return torch.index_select(x, 0, A.perm)


_SPMV = {"coo": spmv_coo, "csr": spmv_csr, "dia": spmv_dia,
         "ell": spmv_ell, "ellr": spmv_ell, "hyb": spmv_hyb}


def multiply(A, B, *, use_autotuning: bool | None = None):
    """C = A @ B.  An operator applies itself; a sparse matrix times a
    vector or a dense block (a tensor (n, k) or an Array2d, read through its
    logical view) takes the format's plain path; a sparse or permutation
    matrix times a sparse or permutation matrix is an SpGEMM
    (ops/spgemm.py) on A's device; dense × sparse is (B^T A^T)^T; dense ×
    dense is torch.matmul.  When autotuning is enabled (autotune.enable(),
    parity with cusp::ktt::enable) a sparse matrix of a tunable format
    routes through one tuning iteration instead, unless
    use_autotuning=False (the reference's hook,
    generic/multiply.inl:125-163)."""
    from cusp_autotuned_tpu_torch.operators import OPERATOR_TYPES
    if isinstance(B, F.Array2d):
        # sparse/operator x array2d block: the kernels read a row-major
        # contiguous block, which a pitched or column-major buffer is not
        B = B.to_dense().contiguous()
    if isinstance(A, OPERATOR_TYPES):
        return A(B)
    if F.is_sparse(A) or isinstance(A, F.PermutationMatrix):
        if F.is_sparse(B) or isinstance(B, F.PermutationMatrix):
            from cusp_autotuned_tpu_torch.ops.spgemm import spgemm
            return spgemm(A, B)
        if isinstance(A, F.PermutationMatrix):
            return spmv_permutation(A, torch.as_tensor(B, device=A.device))
        B = torch.as_tensor(B, device=A.device)
        if B.shape[0] != A.num_cols:
            raise InvalidInputException(
                f"dimension mismatch: {A.shape} @ {tuple(B.shape)}")
        if use_autotuning is not False and B.dim() in (1, 2):
            from cusp_autotuned_tpu_torch import autotune
            if autotune.is_enabled() and A.format in autotune.TUNABLE_FORMATS:
                return autotune.multiply(A, B)
        return _SPMV[A.format](A, B)
    if F.is_sparse(B):
        from cusp_autotuned_tpu_torch.ops.transpose import transpose
        A = torch.as_tensor(A, device=B.device)
        yt = multiply(transpose(B), A.transpose(-1, -2).contiguous()
                      if A.dim() > 1 else A)
        return yt.transpose(-1, -2) if yt.dim() > 1 else yt
    return torch.matmul(A, B)


def generalized_spgemm(A, B, initialize, combine, reduce):
    """Semiring SpGEMM (parity: cusp/detail/multiply.inl:114-151):
    C_ij = reduce over k of combine(A_ik, B_kj); `initialize` is ignored,
    as in the JAX package (ops/spgemm.py)."""
    from cusp_autotuned_tpu_torch.ops.spgemm import spgemm
    return spgemm(A, B, initialize=initialize, combine=combine, reduce=reduce)


def coo_view(A):
    """(row, col, val) tensors of A's stored entries on its device, grouped
    by row except for HYB (its ELL part, then its COO part): COO and CSR
    trimmed of their padding, ELL and ELLR slots without the -1 sentinel,
    DIA slots inside the matrix with nonzero data, as the JAX package's
    view reads them."""
    if isinstance(A, (F.COO, F.CSR)):
        return A.row[:A.nnz], A.col[:A.nnz], A.val[:A.nnz]
    if isinstance(A, (F.ELL, F.ELLR)):
        rows = torch.arange(A.col.shape[1], device=A.col.device).expand_as(A.col)
        ok = (A.col != F.INVALID_INDEX).t()         # row-major: sorted by row
        return rows.t()[ok], A.col.t()[ok], A.val.t()[ok]
    if isinstance(A, F.HYB):
        parts = [coo_view(A.ell), coo_view(A.coo)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))
    if isinstance(A, F.DIA):
        m, n = A.shape
        rows = torch.arange(A.data.shape[1], device=A.device)[None, :]
        cols = rows + torch.tensor(A.offsets, device=A.device)[:, None]
        ok = ((cols >= 0) & (cols < n) & (rows < m) & (A.data != 0)).t()
        return (rows.expand_as(cols).t()[ok], cols.t()[ok], A.data.t()[ok])
    raise TypeError(f"no COO view for {type(A)}")


# reduce -> (scatter_reduce mode, the same reduce on two tensors)
_SCATTER_REDUCE = {torch.maximum: ("amax", torch.maximum),
                   max: ("amax", torch.maximum),
                   torch.minimum: ("amin", torch.minimum),
                   min: ("amin", torch.minimum),
                   operator.mul: ("prod", torch.mul),
                   torch.mul: ("prod", torch.mul),
                   torch.multiply: ("prod", torch.mul)}


def generalized_spmv(A, x, y, initialize, combine, reduce):
    """z[i] = reduce(initialize(y[i]), reduce_{j in row i} combine(A_ij, x_j)),
    and z[i] = initialize(y[i]) for a row with no entry.

    Parity: cusp::generalized_spmv (cusp/detail/multiply.inl:160-199) and
    the JAX package's ops/multiply.py:155-192.  Addition goes through
    index_add_, max, min and mul through scatter_reduce, and any other
    associative reduce (a function of two tensors) through a stable sort
    by row and ops.segment.segment_reduce."""
    from cusp_autotuned_tpu_torch.ops.segment import segment_reduce, segment_sum
    x = torch.as_tensor(x, device=A.device)
    y = torch.as_tensor(y, device=A.device)
    row, col, val = coo_view(A)
    row = row.long()
    init = initialize(y)
    combined = combine(val, torch.index_select(x, 0, col.long()))
    if reduce in (operator.add, torch.add):
        return init + segment_sum(combined, row, A.num_rows)
    # the rows with an entry (index_fill_, unlike bincount, needs no read
    # of the device for its size)
    mask = torch.zeros(A.num_rows, dtype=torch.bool, device=A.device).index_fill_(0, row, True)
    if reduce in _SCATTER_REDUCE:
        mode, reduce = _SCATTER_REDUCE[reduce]
        contrib = torch.zeros(A.num_rows, dtype=combined.dtype, device=A.device)
        contrib = contrib.scatter_reduce_(0, row, combined, mode, include_self=False)
    else:
        order = torch.sort(row, stable=True).indices
        contrib, mask = segment_reduce(combined[order], row[order], A.num_rows,
                                       reduce)
    return torch.where(mask, reduce(init, contrib), init)
