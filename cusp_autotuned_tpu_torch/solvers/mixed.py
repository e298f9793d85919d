"""Mixed-precision iterative refinement, defect correction (counterpart of
cusp_autotuned_tpu/solvers/mixed.py; no reference analogue: the idiom is
LAPACK's dsgesv applied to Krylov solves):

    r_k = b - A x_k             (the residual at full precision)
    d_k = solve(A_lo, r_k)      (an inner Krylov solve to a loose tolerance
                                 on an operator that stores A's values in
                                 bf16)
    x_{k+1} = x_k + d_k

The inner operator is planned_operator(A, {..., "value_dtype":
"bfloat16"}): on the card the hand kernels' bf16-storage instantiations,
which halve the value stream of the bandwidth-bound SpMV while
accumulating in f32.  Each outer sweep cuts the error by about the inner
tolerance until the bf16 operator's own error (~2^-8 sqrt(row nnz)) stops
it.  The outer loop reads one residual norm a sweep on the host.

The outer residual is taken in A's own type, so an f32 A refines no
further than the rounding of b - A x in f32, eps ||A|| ||x|| / ||b||,
which grows with A's condition number.  On the card the kernels take bf16
values with f32 vectors only, so a 16-bit inner plan needs an f32 A there.

The JAX package hands a container A to the inner solver as it is (its
containers are callable, and it plans only what is not), so its inner
solves run at full precision; here every sparse container is planned.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.operators import (
    as_operator, planned_operator, solve_operator,
)
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.cg import cg
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor, default_monitor


def refine(A, b, x0=None, monitor: Monitor | None = None, M=None,
           inner=cg, config=None, inner_rtol=1e-3, inner_limit=200,
           value_dtype="bfloat16"):
    """Solve A x = b by defect correction over a reduced-precision inner
    operator.  Returns (x, monitor).

    A            a sparse container (planned twice: at full precision for
                 the outer residuals, in `value_dtype` for the inner
                 solves) or an operator, used for both.
    monitor      the OUTER monitor: one residual norm a sweep, so its
                 iteration limit bounds the sweeps.
    inner        the inner Krylov solver (cg; bicgstab, cr or gmres for a
                 non-symmetric A).
    config       the inner plan's configuration (a tuned one, say);
                 `value_dtype` is added to it.
    inner_rtol, inner_limit
                 the inner solve's relative tolerance and iteration limit;
                 keep inner_rtol well above the bf16 operator's error."""
    b = torch.as_tensor(b)
    if monitor is None:
        monitor = default_monitor(b)
    cfg = dict(config) if config is not None else {}
    if value_dtype:
        cfg["value_dtype"] = value_dtype
    A_lo = planned_operator(A, cfg) if F.is_sparse(A) else as_operator(A)
    A_hi = solve_operator(A)
    M = as_operator(solve_operator(M))
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).clone()
    monitor.reset(b)
    while True:
        r = b - multiply(A_hi, x)
        if monitor.finished(r):
            break
        d, _ = inner(A_lo, r, monitor=Monitor(r, iteration_limit=inner_limit,
                                              relative_tolerance=inner_rtol), M=M)
        x = x + d
    return x, monitor


def mixed_precision_cg(A, b, **kwargs):
    """refine with inner=cg."""
    return refine(A, b, inner=cg, **kwargs)
