"""LOBPCG (counterpart of cusp_autotuned_tpu/eigen/lobpcg.py; parity target
cusp/eigen/lobpcg.h: lobpcg(A, S, X, monitor, largest) computes one extreme
eigenpair, optionally preconditioned).

Each step solves the 3x3 Rayleigh-Ritz problem in the span {x, w, p}.  The
operator is applied to the orthonormalized (n, 3) block Q in one call, a
dense block for the SpMM kernels (the JAX package maps its SpMV over the
three columns with jax.vmap).  The JAX package runs the whole loop as one
while_loop on the device; here the loop runs on the host but reads the
stop flag only once per CHECK_EVERY iterations, as solvers/cg.py does.
Once the flag is up, the rest of the block is masked: x, p and the
eigenvalue keep their values and the count stops, so the result and the
count are those of a loop that tests the flag every iteration.  (The 3x3
torch.linalg.eigh itself waits for the device on a GPU.)
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.eigen.gram_schmidt import gram_schmidt
from cusp_autotuned_tpu_torch.eigen.spectral_radius import start_vector
from cusp_autotuned_tpu_torch.operators import as_operator
from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply

CHECK_EVERY = 32


def lobpcg(A, x0=None, M=None, largest: bool = True, maxiter: int = 100,
           tol: float = 1e-6, seed: int = 0, return_iterations: bool = False):
    """(eigenvalue, eigenvector) of the largest (or smallest) eigenpair of a
    symmetric A, a matrix or an operator with num_rows, dtype and device.
    x0 defaults to the JAX package's seeded start vector.  The iteration
    stops when |A x - lambda x| <= tol |lambda| or after maxiter steps;
    return_iterations=True adds the number of steps taken."""
    x0 = start_vector(A, seed, x0)
    Mop = as_operator(M)
    sign = 1.0 if largest else -1.0

    def rayleigh(x):
        return blas.dotc(x, multiply(A, x)) / blas.dotc(x, x)

    x = x0 / blas.nrm2(x0)
    p = torch.zeros_like(x)
    lam = rayleigh(x)
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    steps = torch.zeros((), dtype=torch.int64, device=x.device)
    taken = 0
    while taken < maxiter and not bool(done):      # one host read a block
        for _ in range(min(CHECK_EVERY, maxiter - taken)):
            r = multiply(A, x) - lam * x
            S = torch.stack([x, Mop(r), p], dim=1)      # (n, 3)
            Q = gram_schmidt(S)
            colnorm = torch.linalg.vector_norm(Q, dim=0)  # ~0: degenerate
            G = Q.T @ multiply(A, Q)
            # keep degenerate directions out of the argmax/argmin
            penalty = torch.where(colnorm < 0.5, -sign * 1e30, 0.0).to(G.dtype)
            vals, vecs = torch.linalg.eigh(G + torch.diag(penalty))
            c = vecs[:, torch.argmax(sign * vals)]
            x_new = Q @ c
            x_new = x_new / blas.nrm2(x_new)
            p_new = Q[:, 1:] @ c[1:]
            pn = blas.nrm2(p_new)
            p_new = torch.where(pn > 1e-12, p_new / torch.where(pn > 0, pn, 1),
                                p_new)
            lam_new = rayleigh(x_new)
            stop = blas.nrm2(r) <= tol * torch.abs(lam_new) + 1e-30
            x = torch.where(done, x, x_new)
            p = torch.where(done, p, p_new)
            lam = torch.where(done, lam, lam_new)
            steps = steps + (~done).to(steps.dtype)
            done = done | stop
        taken += CHECK_EVERY
    if return_iterations:
        return lam, x, int(steps)
    return lam, x
