"""Preconditioned conjugate gradients (counterpart of
cusp_autotuned_tpu/solvers/cg.py; parity target cusp::krylov::cg,
cusp/krylov/detail/cg.inl:41-107, with the same defaults: no monitor ->
500 iterations at rtol 1e-5, no M -> identity).

The JAX package runs the whole solve as one while_loop on the device.  Here
the loop runs on the host but never waits for the device inside a block of
CHECK_EVERY iterations: the residual norms, the stop test and the history
stay on the device, and the host reads the stop flag once per block.  Once
the flag drops, the remaining iterations of the block are masked: alpha is
0, so x and r keep their values, p and rz are held, and the monitor
records nothing.  x, the iteration count and the history are those of a
loop that tests the flag every iteration.  With a preconditioner the host
reads the flag every iteration instead: a masked iteration would still
apply M (for AMG a whole V-cycle), which costs far more than the read.
The other Krylov solvers share this idiom and the set-up in `start`.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.operators import (
    IdentityOperator, as_operator, solve_operator,
)
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor, default_monitor

CHECK_EVERY = 32


def start(A, b, x0=None, monitor=None, M=None, mesh=None):
    """The set-up that every Krylov solver shares.  Returns (A, b, x,
    monitor, M, check_every): with a mesh, A row-sharded, an AMG hierarchy
    M distributed and b, x0 on the home device; A, and M where it is a
    sparse container, on a CUDA device planned (operators.solve_operator);
    the default monitor where none is given; M as an operator; x a fresh
    copy of x0, zeros without one; and the iterations between two reads of
    the stop flag, CHECK_EVERY with no M and 1 with one."""
    b = torch.as_tensor(b)
    if mesh is not None:
        from cusp_autotuned_tpu_torch.parallel.sharded import (
            distribute_for_solve, distribute_multilevel)
        if hasattr(M, "levels"):
            M = distribute_multilevel(M, mesh)
        A, b, x0 = distribute_for_solve(A, mesh, b, x0)
    if monitor is None:
        monitor = default_monitor(b)
    M = as_operator(solve_operator(M))
    check_every = CHECK_EVERY if isinstance(M, IdentityOperator) else 1
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).clone()
    return solve_operator(A), b, x, monitor, M, check_every


def cg(A, b, x0=None, monitor: Monitor | None = None, M=None, mesh=None):
    """Solve A x = b.  Returns (x, monitor).  b (and x0) are tensors on the
    device that A computes on; a sparse A on a CUDA device runs its
    default kernel (operators.solve_operator).

    mesh: a parallel.RowMesh distributes the solve: a sparse A is
    row-sharded over the mesh (row-aligned for COO/CSR), an AMG hierarchy M
    is distributed (distribute_multilevel), and b and x0 go to the mesh's
    home device, where the loop's vectors and dot products stay."""
    A, b, x, monitor, M, check_every = start(A, b, x0, monitor, M, mesh)
    state = monitor.to_state(b)

    r = b - multiply(A, x)
    z = M(r)
    p = z
    rz = blas.dotc(r, z)
    state.record_(blas.nrm2(r))
    active = state.keep_going()
    while bool(active):                       # the one host read per block
        for _ in range(check_every):
            y = multiply(A, p)
            alpha = torch.where(active, rz / blas.dotc(y, p), 0)
            x = torch.addcmul(x, alpha, p)
            r = torch.addcmul(r, alpha, y, value=-1)
            z = M(r)
            rz_new = blas.dotc(r, z)
            p = torch.where(active, torch.addcmul(z, rz_new / rz, p), p)
            rz = torch.where(active, rz_new, rz)
            state.record_(blas.nrm2(r), active)
            active = torch.logical_and(active, state.keep_going())
    monitor.absorb_state(state)
    return x, monitor
