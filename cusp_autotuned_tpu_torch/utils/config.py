"""Runtime configuration (counterpart of cusp_autotuned_tpu/utils/config.py):
the device rule of the entry points, the storage-dtype rule of the plans,
and the tuner's env-var-backed knobs.

Env vars (all optional):
  CUSP_TORCH_TUNING_CACHE  path of the persistent tuning-results JSON
  CUSP_TORCH_TUNE_BF16     "1": tuning walks also search bf16 value storage

Not ported: `enable_compile_cache`, which turns on XLA's persistent
executable cache (the port's kernels are built once by nvcc into the
package's git-ignored `_build/` directory and loaded from there), and
`plan_budget`, the cap on plan arrays embedded as XLA constants (a plan
here is a set of tensors passed to the kernel at each call).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: `device` when the caller names
    one, else the CUDA device.  Where torch sees no GPU this raises; it
    never falls back to the CPU, which a caller must ask for by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise InvalidInputException(
            "no CUDA device: torch sees no GPU.  The port runs on the card "
            "unless the caller asks for the CPU with device='cpu'")
    return torch.device("cuda")


def _env_bool(name: str) -> bool:
    return os.environ.get(name, "").strip() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    tuning_cache: Optional[str] = dataclasses.field(
        default_factory=lambda: os.environ.get("CUSP_TORCH_TUNING_CACHE"))
    # opt-in: the tuning walk also searches bf16 plan-value storage
    # (value_dtype axis), validated at its own precision class
    search_low_precision: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CUSP_TORCH_TUNE_BF16"))


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


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


def configure(**kwargs) -> Config:
    """Set fields of the configuration by name (tests, embedders); an
    unknown field raises AttributeError."""
    cfg = get_config()
    for k, v in kwargs.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(cfg, k, v)
    return cfg
