"""Matrix-free operators, unordered-triplet assembly, and custom monitors.

Covers three reference example families in one script:
  - examples/LinearOperator/stencil.cu: a user-defined operator (here a
    5-point stencil apply in torch, no stored matrix) driving cg();
  - examples/MatrixAssembly/unordered_triplets.cu: building a COO matrix
    from unsorted (i, j, v) triplets with duplicates summed;
  - examples/Monitors/{monitor,verbose_monitor}.cu: configuring the
    convergence monitor and reading its statistics.
"""

import sys

import torch

from cusp_autotuned_tpu_torch import solvers
from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.operators import make_linear_operator
from cusp_autotuned_tpu_torch.ops.printing import print_matrix
from cusp_autotuned_tpu_torch.utils.config import resolve_device


def assembly(device=None):
    # ten unordered triplets on a 3x3 grid, duplicates summed (reference
    # sorts with two stable sorts then reduces by (i, j) key)
    I = [2, 0, 1, 2, 1, 0, 2, 0, 1, 0]
    J = [0, 2, 1, 0, 1, 0, 2, 0, 0, 0]
    V = [10.0] * 10
    A = coo_matrix(I, J, V, (3, 3), sum_duplicates=True, device=device)
    print(f"assembled 3x3 from 10 triplets -> {A.nnz} unique entries")
    print_matrix(A)
    return A


def matrix_free_cg(nx=64, ny=64, device=None, dtype=torch.float32):
    device = resolve_device(device)

    # y = A x for the 2-D 5-point Laplacian, written directly on the grid:
    # no matrix is ever stored, the operator is just a function
    def laplacian_apply(x):
        u = x.reshape(nx, ny)
        y = 4.0 * u
        y[1:, :] -= u[:-1, :]
        y[:-1, :] -= u[1:, :]
        y[:, 1:] -= u[:, :-1]
        y[:, :-1] -= u[:, 1:]
        return y.reshape(nx * ny)

    A = make_linear_operator(laplacian_apply, shape=(nx * ny, nx * ny))
    b = torch.ones(nx * ny, dtype=dtype, device=device)

    # a configured monitor: iteration cap, relative tolerance, verbose
    # per-iteration residual printing (reference verbose_monitor.cu)
    monitor = solvers.Monitor(b, iteration_limit=400,
                              relative_tolerance=1e-6, verbose=True)
    x, monitor = solvers.cg(A, b, monitor=monitor)
    print(f"matrix-free CG: {monitor.iteration_count()} iterations, "
          f"converged={monitor.converged()}")
    print(f"geometric convergence rate: "
          f"{monitor.geometric_rate():.4f}")
    r = b - laplacian_apply(x)
    true = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    print(f"true residual: {true:.3e}")
    return {"iterations": monitor.iteration_count(),
            "converged": monitor.converged(),
            "geometric_rate": monitor.geometric_rate(), "true_residual": true}


def main(device=None):
    A = assembly(device)
    return {"unique_entries": A.nnz, **matrix_free_cg(device=device)}


if __name__ == "__main__":
    main(*sys.argv[1:])
