"""cusp_autotuned_tpu_torch — the PyTorch and CUDA port of cusp_autotuned_tpu
for NVIDIA Hopper (H100).

The JAX package `cusp_autotuned_tpu` is the reference; this package mirrors
its module paths, so each module's counterpart has the same name.  It
imports neither JAX nor the JAX package.  Containers are frozen dataclasses
of tensors with `.to(device)`; verbs are functions on tensors.  Every
kernel that the reference wrote in Pallas for the TPU becomes a CUDA kernel
under `csrc/`, built on first use (kernels/_build.py); beside each sits a
plain PyTorch version, which the wrapper takes for CPU tensors.

Ported so far (the cg.cu main path):
  formats/   COO, CSR, DIA
  ops/       convert (coo/csr/dia), multiply, BLAS-1 for CG
  kernels/   DIA SpMV and CSR SpMV kernels, the variant registry
  gallery/   stencil generator, poisson5pt, poisson9pt
  solvers/   Monitor, cg
  backend/   scipy oracle
  operators  Identity/Function/Planned operators
  interop    containers from the JAX package's arrays (tests)
"""

__version__ = "0.1.0"

from cusp_autotuned_tpu_torch import (
    backend, formats, gallery, kernels, ops, solvers, utils,
)
from cusp_autotuned_tpu_torch.operators import (
    IdentityOperator, FunctionOperator, PlannedOperator, planned_operator,
    as_operator,
)
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
