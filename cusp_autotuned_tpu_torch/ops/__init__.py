"""Verbs (counterpart of cusp_autotuned_tpu/ops; convert, multiply and the
BLAS-1 verbs that CG uses are ported so far)."""

from cusp_autotuned_tpu_torch.ops import blas
