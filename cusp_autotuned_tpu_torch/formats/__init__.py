"""Containers (counterpart of cusp_autotuned_tpu/formats): COO, CSR, DIA,
ELL, ELLR, HYB, the permutation matrix and the dense Array2d.

Not ported: the JAX package's `register_matrix` and `static_field`
(formats/base.py), which register containers as JAX pytrees; a container
here is a frozen dataclass of tensors."""

from cusp_autotuned_tpu_torch.formats.base import MatrixBase
from cusp_autotuned_tpu_torch.formats.coo import COO, coo_matrix, coo_from_scipy
from cusp_autotuned_tpu_torch.formats.csr import CSR, csr_matrix, csr_from_scipy
from cusp_autotuned_tpu_torch.formats.dense import (
    Array2d, array1d, array1d_view, array2d, make_array2d_view,
)
from cusp_autotuned_tpu_torch.formats.dia import DIA, dia_matrix
from cusp_autotuned_tpu_torch.formats.ell import (
    ELL, ELLR, ell_matrix, ellr_matrix, INVALID_INDEX,
)
from cusp_autotuned_tpu_torch.formats.hyb import HYB, hyb_matrix
from cusp_autotuned_tpu_torch.formats.permutation import (
    PermutationMatrix, permutation_matrix,
)

SPARSE_FORMATS = ("coo", "csr", "dia", "ell", "ellr", "hyb")

_FORMAT_CLASSES = {
    "coo": COO, "csr": CSR, "dia": DIA, "ell": ELL, "ellr": ELLR,
    "hyb": HYB, "permutation": PermutationMatrix,
}


def format_class(name: str):
    """The container class of a format name."""
    try:
        return _FORMAT_CLASSES[name]
    except KeyError:
        raise ValueError(f"unknown format {name!r}; known: "
                         f"{sorted(_FORMAT_CLASSES)}") from None


def is_sparse(a) -> bool:
    return isinstance(a, MatrixBase) and getattr(a, "format", None) in SPARSE_FORMATS


def is_coo(a) -> bool:
    return isinstance(a, COO)


def is_csr(a) -> bool:
    return isinstance(a, CSR)


def is_dia(a) -> bool:
    return isinstance(a, DIA)


def is_ell(a) -> bool:
    return isinstance(a, ELL)


def is_ellr(a) -> bool:
    return isinstance(a, ELLR)


def is_hyb(a) -> bool:
    return isinstance(a, HYB)


def is_permutation(a) -> bool:
    return isinstance(a, PermutationMatrix)
