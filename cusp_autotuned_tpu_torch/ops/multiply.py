"""multiply — SpMV / SpMM / operator apply (counterpart of
cusp_autotuned_tpu/ops/multiply.py; parity target cusp/multiply.h and the
format-specialised SpMV of cusp/system/detail/generic/multiply/spmv.h).

The per-format functions here are the plain PyTorch paths, for x of shape
(n,) or (n, k), on any device.  The hand-written kernels are reached
through kernels.variants.build_spmv and operators.planned_operator.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
from cusp_autotuned_tpu_torch.kernels.dia import dia_spmv_plain
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)


def spmv_coo(A: F.COO, x):
    return csr_spmv_plain(A.row, A.col, A.val, x, A.num_rows)


def spmv_csr(A: F.CSR, x):
    return csr_spmv_plain(A.row, A.col, A.val, x, A.num_rows)


def spmv_dia(A: F.DIA, x):
    return dia_spmv_plain(A.data, A.offsets, x, A.shape)


_SPMV = {"coo": spmv_coo, "csr": spmv_csr, "dia": spmv_dia}


def multiply(A, B):
    """C = A @ B.  An operator applies itself; a sparse matrix times a
    vector or a dense block takes the format's plain path; dense × dense is
    torch.matmul."""
    from cusp_autotuned_tpu_torch.operators import OPERATOR_TYPES
    if isinstance(A, OPERATOR_TYPES):
        return A(B)
    if F.is_sparse(A):
        if F.is_sparse(B):
            raise NotImplementedException("sparse x sparse is not ported yet")
        B = torch.as_tensor(B, device=A.device)
        if B.shape[0] != A.num_cols:
            raise InvalidInputException(
                f"dimension mismatch: {A.shape} @ {tuple(B.shape)}")
        return _SPMV[A.format](A, B)
    if F.is_sparse(B):
        raise NotImplementedException("dense x sparse is not ported yet")
    return torch.matmul(A, B)
