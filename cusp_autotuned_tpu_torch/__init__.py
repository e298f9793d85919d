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
scattered rails, smoothed-aggregation AMG, the Krylov family, the graph
slice and the SpGEMM slice):
  formats/   COO, CSR, DIA, ELL, ELLR, HYB, the permutation matrix, the
             dense Array2d
  ops/       convert, multiply (vectors, dense blocks with the autotune
             hook, SpGEMM by expand-sort-compress with semirings, dense x
             sparse), generalized_spmv, generalized_spgemm and the
             segmented reductions, transpose, elementwise/add/subtract,
             sort, format_utils, verify, printing, functional,
             iterator_utils, the BLAS verbs, LAPACK through torch.linalg
             (host scipy for sytrf/sytrs and stev/stsv)
  kernels/   DIA, CSR, row-binned CSR and nnz-balanced COO SpMV kernels;
             DIA, row-binned and COO SpMM kernels for dense blocks (n, k);
             the variant registry (rcm_dia among its moves) and the tuning
             spaces
  autotune/  the KTT-style tuner, tuned_operator, choose_format, the
             calibration (stream triad, take probe) and the cost model that
             picks an impl before anything is built
  precond/   diagonal, AINV (scaled, unscaled, non-symmetric), Jacobi,
             Gauss-Seidel, SOR and polynomial smoothers, smoothed-
             aggregation AMG (strength, standard, MIS and grid-blocked
             aggregation, structured RAP, Multilevel)
  relaxation/ Jacobi, multicolour Gauss-Seidel, SOR, Chebyshev polynomial
  graph/     BFS, connected components, MIS(k), vertex colouring, symmetric
             RCM, the pseudo-peripheral vertex, Hilbert partitioning
  native/    the host aggregator, RCM orderings and AINV factorisations,
             built with g++ at first use
  gallery/   stencil generator, poisson 5/7/9/27-point, grid2d/grid3d,
             diffusion (FE, FD), random, the fork's diagonal generators
  io/        MatrixMarket, binary (.npz and the reference's raw layout),
             DIMACS
  utils/     the device rule, exceptions, the call-tree tracer, profiling
  solvers/   Monitor, cg, cr, bicg, bicgstab, gmres, cg_m, bicgstab_m,
             refine and mixed_precision_cg
  eigen/     lobpcg, lanczos, arnoldi, gram_schmidt, spectral radius
  backend/   scipy oracle
  operators  Identity/Function/Planned operators, the factored and
             grid-blocked AMG level operators
  interop    containers from the JAX package's arrays (tests)

Every entry point that builds tensors builds them on the CUDA device unless
the caller names another (utils.config.resolve_device).
"""

__version__ = "0.1.0"

from cusp_autotuned_tpu_torch.formats import (
    COO, CSR, DIA, ELL, ELLR, HYB, PermutationMatrix,
    is_sparse, is_coo, is_csr, is_dia, is_ell, is_ellr, is_hyb,
)
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.multiply import (
    multiply, generalized_spmv, generalized_spgemm,
)
from cusp_autotuned_tpu_torch.ops.transpose import transpose
from cusp_autotuned_tpu_torch.ops.elementwise import add, subtract, elementwise
from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.verify import is_valid_matrix, assert_is_valid_matrix
from cusp_autotuned_tpu_torch.ops.printing import print_matrix
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import (
    CuspException, FormatException, FormatConversionException,
    NotImplementedException, InvalidInputException, RuntimeException,
)

from cusp_autotuned_tpu_torch import (
    autotune, backend, eigen, formats, gallery, graph, io, kernels, ops,
    precond, relaxation, solvers, utils,
)
from cusp_autotuned_tpu_torch.operators import (
    IdentityOperator, FunctionOperator, PlannedOperator, planned_operator,
    as_operator, identity_operator, make_linear_operator,
)
