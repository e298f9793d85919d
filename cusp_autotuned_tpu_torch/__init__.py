"""cusp_autotuned_tpu_torch — the PyTorch and CUDA port of cusp_autotuned_tpu
for NVIDIA Hopper (H100).

The JAX package `cusp_autotuned_tpu` is the reference; this package mirrors
its module paths, so each module's counterpart has the same name.  It
imports neither JAX nor the JAX package.  Containers are frozen dataclasses
of tensors with `.to(device)`; verbs are functions on tensors.  Every
kernel that the reference wrote in Pallas for the TPU becomes a CUDA kernel
under `csrc/`, built on first use (kernels/_build.py); beside each sits a
plain PyTorch version, which the wrapper takes for CPU tensors.

Ported so far (the cg.cu main path, the autotuner, the block multiply, the
scattered rails and smoothed-aggregation AMG):
  formats/   COO, CSR, DIA, ELL, ELLR, HYB, the dense Array2d
  ops/       convert, multiply (vectors and dense blocks, with the autotune
             hook), BLAS-1 for CG
  kernels/   DIA, CSR, row-binned CSR and nnz-balanced COO SpMV kernels;
             DIA, row-binned and COO SpMM kernels for dense blocks (n, k);
             the variant registry and the tuning spaces
  autotune/  the KTT-style tuner, tuned_operator, choose_format, the
             calibration (stream triad, take probe) and the cost model that
             picks an impl before anything is built
  precond/   diagonal, Jacobi and polynomial smoothers, smoothed-aggregation
             AMG (strength, aggregation, structured RAP, Multilevel)
  relaxation/ Jacobi, Chebyshev polynomial
  native/    the host aggregator, built with g++ at first use
  gallery/   stencil generator, poisson5pt, poisson9pt, random, the fork's
             diagonal generators
  solvers/   Monitor, cg
  eigen/     lobpcg, lanczos, arnoldi, gram_schmidt, spectral radius
  backend/   scipy oracle
  operators  Identity/Function/Planned operators, the factored and
             grid-blocked AMG level operators
  interop    containers from the JAX package's arrays (tests)

Every entry point that builds tensors builds them on the CUDA device unless
the caller names another (utils.config.resolve_device).
"""

__version__ = "0.1.0"

from cusp_autotuned_tpu_torch import (
    autotune, backend, eigen, formats, gallery, kernels, ops, precond,
    relaxation, solvers, utils,
)
from cusp_autotuned_tpu_torch.operators import (
    IdentityOperator, FunctionOperator, PlannedOperator, planned_operator,
    as_operator,
)
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
