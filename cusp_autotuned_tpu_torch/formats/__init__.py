"""Sparse containers (counterpart of cusp_autotuned_tpu/formats; COO, CSR and
DIA are ported so far)."""

from cusp_autotuned_tpu_torch.formats.base import MatrixBase
from cusp_autotuned_tpu_torch.formats.coo import COO, coo_matrix
from cusp_autotuned_tpu_torch.formats.csr import CSR, csr_matrix
from cusp_autotuned_tpu_torch.formats.dia import DIA, dia_matrix

SPARSE_FORMATS = ("coo", "csr", "dia")


def is_sparse(a) -> bool:
    return isinstance(a, MatrixBase) and getattr(a, "format", None) in SPARSE_FORMATS
