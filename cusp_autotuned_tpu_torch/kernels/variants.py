"""SpMV variant registry (counterpart of cusp_autotuned_tpu/kernels/variants.py).

Every variant is a function build(A, config) -> fn(x) -> y.  The port's
impls so far:

  dia       slices (plain shifted slices), cuda (csrc/dia_spmv.cu)
  csr, coo  segsum (plain gather + index_add_), via_dia (re-lay the matrix
            out as DIA and run an inner DIA impl, `dia_impl`), cuda
            (csrc/csr_spmv.cu)

`cuda` stands where the JAX package has `pallas`.  For a matrix on a CUDA
device the default impl is `cuda`, and via_dia's default `dia_impl` is
`cuda`; on the CPU the defaults are the plain paths, as in the reference.
The tuning spaces are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException


def _build_dia_slices(A, config):
    from cusp_autotuned_tpu_torch.ops.multiply import spmv_dia
    # value_dtype holds on the plain path too: bf16 data is widened to x's
    # dtype before each product
    store = plan_value_dtype(config, A.dtype)
    if store != A.dtype:
        A = dataclasses.replace(A, data=A.data.to(store))

    def fn(x):
        return spmv_dia(A, x)
    return fn


def _build_csr_segsum(A, config):
    from cusp_autotuned_tpu_torch.ops.multiply import spmv_csr

    def fn(x):
        return spmv_csr(A, x)
    return fn


def _build_coo_segsum(A, config):
    from cusp_autotuned_tpu_torch.ops.multiply import spmv_coo

    def fn(x):
        return spmv_coo(A, x)
    return fn


def _build_cuda(format_name):
    def build(A, config):
        from cusp_autotuned_tpu_torch.kernels import pallas_spmv
        return pallas_spmv.build(format_name, A, config)
    return build


def _inner_dia_impl(config, D):
    """Inner DIA impl for via_dia: an explicit dia_impl wins; otherwise the
    kernel for a matrix on a CUDA device, the plain slices on the CPU."""
    d = config.get("dia_impl")
    if d not in (None, "none", 0):
        return d
    return "cuda" if D.device.type == "cuda" else "slices"


def _build_via_dia(A, config):
    """Format-selection move: re-lay the matrix out as DIA (distinct col-row
    deltas become diagonals) and run a DIA impl.  The conversion's fill
    guard rejects patterns with too many diagonals."""
    from cusp_autotuned_tpu_torch.ops.convert import convert
    D = convert(A, "dia")
    fn = build_spmv(D, {**config, "impl": _inner_dia_impl(config, D)})
    fn.plan_stats = {"impl": "via_dia"}
    return fn


VARIANTS: Dict[str, Dict[str, Callable]] = {
    "dia": {
        "slices": _build_dia_slices,
        "cuda": _build_cuda("dia"),
    },
    "csr": {
        "segsum": _build_csr_segsum,
        "via_dia": _build_via_dia,
        "cuda": _build_cuda("csr"),
    },
    "coo": {
        "segsum": _build_coo_segsum,
        "via_dia": _build_via_dia,
        "cuda": _build_cuda("coo"),
    },
}

_DEFAULTS = {
    "dia": {"impl": "slices"},
    "csr": {"impl": "segsum", "dia_impl": "none"},
    "coo": {"impl": "segsum", "dia_impl": "none"},
}


def default_config(A) -> Dict[str, Any]:
    cfg = dict(_DEFAULTS[A.format])
    if A.device.type == "cuda":
        cfg["impl"] = "cuda"
    return cfg


def build_spmv(A, config: Dict[str, Any]) -> Callable:
    impl = config.get("impl") or default_config(A)["impl"]
    try:
        builder = VARIANTS[A.format][impl]
    except KeyError:
        raise NotImplementedException(
            f"no variant {impl!r} for format {A.format!r}") from None
    return builder(A, config)
