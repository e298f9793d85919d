"""Large unstructured operators: planned kernels as solver arguments.

A tuned SpMV kernel plans its entry layout once, on the device; wrapping
the plan in a PlannedOperator hands a Krylov solve the planned tensors,
which every product reads in place.  The JAX example's streamed-window
rail (x and y blocks pipelined through VMEM past its budget) has no
counterpart: the card reads x through L1/L2 at any size, so the same
binned plan serves a larger matrix as it is."""

import sys

import torch

from cusp_autotuned_tpu_torch import autotune, gallery, solvers
from cusp_autotuned_tpu_torch.operators import planned_operator


def main(device=None, n=120, n_large=150):
    # an unstructured operator (CSR); the binned kernel plans it
    A = gallery.poisson9pt(n, n, format="csr", dtype=torch.float32, device=device)
    op = planned_operator(A, {"impl": "binned", "block_size": 256})
    b = torch.ones(A.num_rows, dtype=torch.float32, device=A.device)
    x, mon = solvers.cg(op, b, monitor=solvers.Monitor(b, 2000, 1e-5))
    print(f"planned-operator CG: converged={mon.converged()} "
          f"in {mon.iteration_count()} iterations")

    # or let the autotuner pick the configuration (offline search + cache)
    op2 = autotune.tuned_operator(A)
    y = op2(b)
    y_norm = float(torch.linalg.norm(y))
    print(f"tuned operator applied: ||y|| = {y_norm:.3e}")

    # the same plan on a larger grid
    B = gallery.poisson9pt(n_large, n_large, format="csr", dtype=torch.float32,
                           device=device)
    op3 = planned_operator(B, {"impl": "binned", "block_size": 256})
    r = op3(torch.ones(B.num_cols, dtype=torch.float32, device=B.device))
    finite = bool(torch.isfinite(r).all())
    print(f"planned binned SpMV on {B.num_rows} rows: finite={finite}")
    return {"iterations": mon.iteration_count(), "converged": mon.converged(),
            "y_norm": y_norm, "large_finite": finite}


if __name__ == "__main__":
    main(*sys.argv[1:])
