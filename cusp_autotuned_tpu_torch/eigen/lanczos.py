"""Lanczos eigensolver (counterpart of cusp_autotuned_tpu/eigen/lanczos.py;
parity target cusp/eigen/lanczos.h and lanczos_options.h: the options carry
the iteration count, which end of the spectrum, the tolerance and the
reorthogonalization strategy)."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg as sla
import torch

from cusp_autotuned_tpu_torch.eigen.spectral_radius import _lanczos_tridiag


@dataclasses.dataclass
class LanczosOptions:
    iteration_limit: int = 100
    tolerance: float = 1e-6
    which: str = "LA"          # LA = largest algebraic, SA = smallest
    num_eigvals: int = 1
    reorthogonalize: bool = True
    seed: int = 0


def lanczos(A, options: LanczosOptions | None = None, *, return_eigvecs=False,
            mesh=None):
    """Eigenvalues (and, with return_eigvecs, eigenvectors as the columns
    of an (n, num_eigvals) tensor) of a symmetric A: a Lanczos
    tridiagonalization with full reorthogonalization on A's device, then
    the tridiagonal eigenproblem on the host (the lapack stev path).  The
    results land on A's device.  mesh: a parallel.RowMesh row-shards a
    sparse A over the mesh; the Lanczos vectors stay on its home device."""
    if mesh is not None:
        from cusp_autotuned_tpu_torch.parallel.sharded import distribute_for_solve
        A = distribute_for_solve(A, mesh)[0]
    options = options or LanczosOptions()
    k = min(options.iteration_limit, A.num_rows)
    alphas, betas, V = _lanczos_tridiag(A, k, options.seed)
    m = len(alphas)
    w, S = sla.eigh_tridiagonal(alphas, betas[: m - 1])
    order = np.argsort(w)
    if options.which.upper() in ("LA", "LM"):
        order = order[::-1]
    idx = order[: options.num_eigvals]
    eigvals = torch.from_numpy(w[idx].copy()).to(A.device)
    if not return_eigvecs:
        return eigvals
    return eigvals, torch.from_numpy(V[:m].T @ S[:, idx]).to(A.device)
