"""Registry-facing entry point of the hand-written SpMV kernels (counterpart
of cusp_autotuned_tpu/kernels/pallas_spmv.py, whose `pallas` impl the port
calls `cuda`).  Every build function returns fn(x) -> y exposing
`planned_arrays` and `apply`, so operators.planned_operator packages it; a
plan that cannot be built raises FormatConversionException or
NotImplementedException, which the tuner records as a skippable status."""

from __future__ import annotations

from cusp_autotuned_tpu_torch.kernels.binned import build_binned  # noqa: F401
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort  # noqa: F401
from cusp_autotuned_tpu_torch.kernels.colsort2 import build_colsort2  # noqa: F401
from cusp_autotuned_tpu_torch.kernels.routed import build_routed  # noqa: F401
from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException


def build(format_name, A, config):
    if format_name == "dia":
        from cusp_autotuned_tpu_torch.kernels.dia import build_dia
        return build_dia(A, config)
    if format_name in ("csr", "coo", "ell", "ellr", "hyb"):
        # the CSR kernel plans from the matrix's entries in any format
        from cusp_autotuned_tpu_torch.kernels.csr import build_csr
        return build_csr(A, config)
    raise NotImplementedException(
        f"cuda kernel for {format_name} not yet available")
