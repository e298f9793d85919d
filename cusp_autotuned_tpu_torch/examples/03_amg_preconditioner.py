"""Smoothed-aggregation AMG as a CG preconditioner
(reference: examples/Preconditioners)."""

import sys

import numpy as np
import torch

from cusp_autotuned_tpu_torch import gallery, precond, solvers
from cusp_autotuned_tpu_torch.operators import planned_operator


def main(device=None, n=150):
    A = gallery.poisson5pt(n, n, format="csr", dtype=torch.float64, device=device)
    b = torch.as_tensor(np.random.RandomState(0).randn(A.num_rows), device=A.device)

    M = precond.smoothed_aggregation(A)
    M.print()                      # hierarchy + complexity report

    x, mon_amg = solvers.cg(A, b, M=M, monitor=solvers.Monitor(b, 100, 1e-8))
    _, mon_cg = solvers.cg(A, b, monitor=solvers.Monitor(b, 2000, 1e-8))
    print(f"AMG-CG: {mon_amg.iteration_count()} iterations; "
          f"plain CG: {mon_cg.iteration_count()}")

    # every level's A, R and P can run through planned kernels, and the CG
    # operator too: here the binned kernel (csrc/binned_spmv.cu)
    cfg = {"impl": "binned"}
    Af = gallery.poisson5pt(n, n, format="csr", dtype=torch.float32, device=device)
    Mt = precond.smoothed_aggregation(Af, spmv_config=cfg)
    bt = b.float()
    xt, mont = solvers.cg(planned_operator(Af, cfg), bt, M=Mt,
                          monitor=solvers.Monitor(bt, 100, 1e-5))
    print(f"fully tuned AMG-CG: {mont.iteration_count()} iterations, "
          f"converged={mont.converged()}")
    return {"levels": len(M.levels) + 1,
            "operator_complexity": M.operator_complexity(),
            "amg_iterations": mon_amg.iteration_count(),
            "amg_residual": mon_amg.residual_norm(),
            "cg_iterations": mon_cg.iteration_count(),
            "tuned_iterations": mont.iteration_count(),
            "tuned_converged": mont.converged()}


if __name__ == "__main__":
    main(*sys.argv[1:])
