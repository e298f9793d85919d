"""Verbs (counterpart of cusp_autotuned_tpu/ops; convert, multiply,
generalized_spmv, the segmented reductions, transpose and the BLAS-1 verbs
that the Krylov solvers use are ported so far)."""

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import generalized_spmv
from cusp_autotuned_tpu_torch.ops.transpose import transpose
