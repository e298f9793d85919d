"""SpMV variants: plain PyTorch paths and hand-written CUDA kernels for
Hopper, behind the registry that build_spmv reads (counterpart of
cusp_autotuned_tpu/kernels)."""

from cusp_autotuned_tpu_torch.kernels.variants import (
    build_spmv, default_config, tuning_space, VARIANTS,
)
