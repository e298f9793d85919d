"""The reference README's "simple example": load/build a matrix, solve with
CG, inspect convergence (reference: examples/Algorithms, examples/Monitors)."""

import sys

import torch

from cusp_autotuned_tpu_torch import gallery, solvers


def main(device=None):
    # 2-D Poisson problem on a 100x100 grid, HYB format
    A = gallery.poisson5pt(100, 100, format="hyb", dtype=torch.float32,
                           device=device)
    b = torch.ones(A.num_rows, dtype=torch.float32, device=A.device)

    monitor = solvers.Monitor(b, iteration_limit=1000,
                              relative_tolerance=1e-6, verbose=False)
    x, monitor = solvers.cg(A, b, monitor=monitor)
    monitor.print()
    return {"iterations": monitor.iteration_count(),
            "residual": monitor.residual_norm(),
            "converged": monitor.converged()}


if __name__ == "__main__":
    main(*sys.argv[1:])
