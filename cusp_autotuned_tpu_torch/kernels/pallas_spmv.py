"""Registry-facing entry point of the hand-written SpMV kernels (counterpart
of cusp_autotuned_tpu/kernels/pallas_spmv.py, whose `pallas` impl the port
calls `cuda`)."""

from __future__ import annotations

from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException


def build(format_name, A, config):
    if format_name == "dia":
        from cusp_autotuned_tpu_torch.kernels.dia import build_dia
        return build_dia(A, config)
    if format_name in ("csr", "coo"):
        from cusp_autotuned_tpu_torch.kernels.csr import build_csr
        return build_csr(A, config)
    raise NotImplementedException(
        f"cuda kernel for {format_name} not yet available")
