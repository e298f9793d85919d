"""multiply — SpMV / SpMM / operator apply (counterpart of
cusp_autotuned_tpu/ops/multiply.py; parity target cusp/multiply.h and the
format-specialised SpMV of cusp/system/detail/generic/multiply/spmv.h).

The per-format functions here are the plain PyTorch paths, for x of shape
(n,) or (n, k), on any device.  The hand-written kernels are reached
through kernels.variants.build_spmv, operators.planned_operator and the
autotuner.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
from cusp_autotuned_tpu_torch.kernels.dia import dia_spmv_plain, promoted
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)


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


_SPMV = {"coo": spmv_coo, "csr": spmv_csr, "dia": spmv_dia,
         "ell": spmv_ell, "ellr": spmv_ell, "hyb": spmv_hyb}


def multiply(A, B, *, use_autotuning: bool | None = None):
    """C = A @ B.  An operator applies itself; a sparse matrix times a
    vector or a dense block (a tensor (n, k) or an Array2d, read through its
    logical view) takes the format's plain path; dense × dense is
    torch.matmul.  When autotuning is enabled (autotune.enable(), parity
    with cusp::ktt::enable) a sparse matrix of a tunable format routes
    through one tuning iteration instead, unless use_autotuning=False (the
    reference's hook, generic/multiply.inl:125-163)."""
    from cusp_autotuned_tpu_torch.operators import OPERATOR_TYPES
    if isinstance(B, F.Array2d):
        # sparse/operator x array2d block: the kernels read a row-major
        # contiguous block, which a pitched or column-major buffer is not
        B = B.to_dense().contiguous()
    if isinstance(A, OPERATOR_TYPES):
        return A(B)
    if F.is_sparse(A):
        if F.is_sparse(B):
            raise NotImplementedException("sparse x sparse is not ported yet")
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
        raise NotImplementedException("dense x sparse is not ported yet")
    return torch.matmul(A, B)
