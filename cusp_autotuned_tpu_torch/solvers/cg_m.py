"""Multi-shift CG: (A + sigma_s I) x_s = b for every shift from one Krylov
space (counterpart of cusp_autotuned_tpu/solvers/cg_m.py; parity target
cusp::krylov::cg_m, cusp/krylov/detail/cg_m.inl: the Jegerlehner CG-M
recurrences KERNEL_ZB, KERNEL_A and KERNEL_XP, x0 = 0, no
preconditioner).

All shifts are updated as one (n_sigma, n) pass an iteration.  A zeta
that reaches 0 (in f32 a well-conditioned shift's zeta underflows long
before the seed system converges) freezes its shift instead of dividing
0/0, as in the JAX package: a zero zeta means that shifted residual is 0
to working precision.  The loop is cg.py's, reading the stop flag once per
block of CHECK_EVERY iterations.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.cg import start
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor


def cg_m(A, b, sigma, monitor: Monitor | None = None, mesh=None):
    """Returns (X, monitor), X[s] solving (A + sigma[s] I) X[s] = b.  The
    monitor follows the unshifted (seed) system, as in the reference; mesh
    as in cg."""
    A, b, _, monitor, _, check_every = start(A, b, None, monitor, None, mesh)
    sigma = torch.as_tensor(sigma).to(dtype=b.dtype, device=b.device)
    ns, n = sigma.shape[0], b.shape[0]
    state = monitor.to_state(b)
    r = b
    rsq = blas.dotc(r, r)
    p = b
    p_s = b.expand(ns, n).clone()
    x_s = b.new_zeros((ns, n))
    z_m1 = b.new_ones(ns)
    z_0 = b.new_ones(ns)
    beta_0 = b.new_ones(())
    alpha_0 = b.new_zeros(())
    state.record_(blas.nrm2(r))
    active = state.keep_going()
    while bool(active):
        for _ in range(check_every):
            beta_m1 = beta_0
            Ap = multiply(A, p)
            beta_new = -rsq / blas.dotc(p, Ap)
            r_new = r + beta_new * Ap
            # shifted zeta and beta (KERNEL_ZB); a dead zeta freezes its shift
            den = (beta_new * alpha_0 * (z_m1 - z_0)
                   + beta_m1 * z_m1 * (1 - beta_new * sigma))
            alive = (z_0 != 0) & (den != 0)
            z_1 = torch.where(alive, z_0 * z_m1 * beta_m1
                              / torch.where(den == 0, 1, den), 0)
            z_0_safe = torch.where(alive, z_0, 1)
            b_s = torch.where(alive, beta_new * z_1 / z_0_safe, 0)
            rsq_new = blas.dotc(r_new, r_new)
            alpha_new = rsq_new / rsq
            # shifted alpha (KERNEL_A), then every shift's x and p (KERNEL_XP)
            a_s = torch.where(alive, (alpha_new / beta_new) * z_1 * b_s / z_0_safe, 0)
            x_s = torch.where(active, x_s - b_s[:, None] * p_s, x_s)
            p_s = torch.where(active, z_1[:, None] * r_new[None, :]
                              + a_s[:, None] * p_s, p_s)
            p = torch.where(active, r_new + alpha_new * p, p)
            r = torch.where(active, r_new, r)
            rsq = torch.where(active, rsq_new, rsq)
            z_m1, z_0 = (torch.where(active, z_0, z_m1),
                         torch.where(active, z_1, z_0))
            beta_0 = torch.where(active, beta_new, beta_0)
            alpha_0 = torch.where(active, alpha_new, alpha_0)
            state.record_(torch.sqrt(torch.real(rsq_new)), active)
            active = torch.logical_and(active, state.keep_going())
    monitor.absorb_state(state)
    return x_s, monitor
