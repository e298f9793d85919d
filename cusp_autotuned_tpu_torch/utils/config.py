"""Plan configuration helpers (counterpart of cusp_autotuned_tpu/utils/config.py;
only the storage-dtype rule is ported so far)."""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException


def plan_value_dtype(config: dict | None, dtype: torch.dtype) -> torch.dtype:
    """Storage dtype for planned value arrays.

    The config key `value_dtype: 'bfloat16'` stores real floating values in
    bf16, halving the value stream of the bandwidth-bound SpMV, while the
    kernels keep accumulating in the matrix dtype (f32).  Anything else
    keeps `dtype`."""
    vd = (config or {}).get("value_dtype", 0)
    if not vd or vd in ("none", "0"):
        return dtype
    if str(vd) not in ("bfloat16", "bf16"):
        raise NotImplementedException(
            f"value_dtype must be 'bfloat16' (got {vd!r})")
    if dtype.itemsize <= 2:
        return dtype                     # already 16-bit storage
    if not dtype.is_floating_point:
        raise NotImplementedException(
            "value_dtype='bfloat16' applies to real floating matrices only")
    return torch.bfloat16
