"""Multi-shift BiCGstab: (A + sigma_s I) x_s = b for every shift
(counterpart of cusp_autotuned_tpu/solvers/bicgstab_m.py; parity target
cusp::krylov::bicgstab_m, cusp/krylov/detail/bicgstab_m.inl: the
Jegerlehner BiCGstab-M recurrences KERNEL_ZB, W, S, CHIRHO, A and XS,
x0 = 0, no preconditioner).

All shifts are updated as one (n_sigma, n) pass an iteration.  A shift
freezes once its zeta falls below the smallest normal number or one of
the recurrences' denominators reaches 0, as cg_m's shifts freeze at a
zero zeta: in f32 a well-conditioned shift's zeta underflows within a
hundred iterations of a system that takes a thousand, and the raw
recurrence then divides 0/0 (or by a subnormal b_s) and fills that
shift's x with NaN.  The JAX package's bicgstab_m has no such guard (its
cg_m has); where no shift freezes the two compute the same values.  The
loop is cg.py's, reading the stop flag once per block of CHECK_EVERY
iterations.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops import blas
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.cg import start
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor


def _safe(v, live):
    return torch.where(live, v, 1)


def bicgstab_m(A, b, sigma, monitor: Monitor | None = None, mesh=None):
    """Returns (X, monitor), X[s] solving (A + sigma[s] I) X[s] = b.  The
    monitor follows the unshifted (seed) system; mesh as in cg."""
    A, b, _, monitor, _, check_every = start(A, b, None, monitor, None, mesh)
    sigma = torch.as_tensor(sigma).to(dtype=b.dtype, device=b.device)
    ns, n = sigma.shape[0], b.shape[0]
    tiny = torch.finfo(b.real.dtype).tiny   # below it a shift freezes
    state = monitor.to_state(b)
    r_0 = w_0 = s_0 = b
    s_s = b.expand(ns, n).clone()
    x_s = b.new_zeros((ns, n))
    z_m1 = b.new_ones(ns)
    z_0 = b.new_ones(ns)
    rho_0 = b.new_ones(ns)
    beta_0 = b.new_ones(())
    alpha_0 = b.new_zeros(())
    As = multiply(A, s_0)
    delta_1 = blas.dotc(w_0, r_0)
    phi_0 = blas.dotc(w_0, As) / delta_1
    state.record_(blas.nrm2(r_0))
    active = state.keep_going()
    while bool(active):
        for _ in range(check_every):
            beta_m1 = beta_0
            beta_new = -1.0 / phi_0
            delta_0 = delta_1
            # shifted zeta and beta (KERNEL_ZB, as in CG-M)
            den = (beta_new * alpha_0 * (z_m1 - z_0)
                   + beta_m1 * z_m1 * (1 - beta_new * sigma))
            live = (z_0 != 0) & (den != 0)
            z_1 = z_0 * z_m1 * beta_m1 / _safe(den, live)
            live = live & (torch.abs(z_1) >= tiny)
            z_1 = torch.where(live, z_1, 0)
            b_s = torch.where(live, beta_new * z_1 / _safe(z_0, live), 0)
            # w_1 = r_0 + beta_0 A s_0 (KERNEL_W)
            w_1 = r_0 + beta_new * As
            Aw = multiply(A, w_1)
            chi_0 = blas.dotc(Aw, w_1) / blas.dotc(Aw, Aw)
            r_1 = w_1 - chi_0 * Aw
            delta_new = blas.dotc(w_0, r_1)
            alpha_new = -beta_new * delta_new / delta_0 / chi_0
            # s_0 = r_1 + alpha_1 (s_0 - chi_0 A s_0) (KERNEL_S)
            s_new = r_1 + alpha_new * (s_0 - chi_0 * As)
            As_new = multiply(A, s_new)
            phi_new = blas.dotc(w_0, As_new) / delta_new
            # shifted chi and rho (KERNEL_CHIRHO), shifted alpha (KERNEL_A)
            den_chi = 1.0 + chi_0 * sigma
            live = live & (den_chi != 0)
            c_s = chi_0 / _safe(den_chi, live)
            rho_1 = torch.where(live, rho_0 / _safe(den_chi, live), rho_0)
            a_s = torch.where(live, (alpha_new / beta_new) * z_1 * b_s
                              / _safe(z_0, live), 0)
            # every shift's x and s (KERNEL_XS)
            x_new = (x_s - b_s[:, None] * s_s
                     + (c_s * rho_0 * z_1)[:, None] * w_1[None, :])
            s_s_new = (z_1 * rho_1)[:, None] * r_1[None, :] + a_s[:, None] * (
                s_s - (c_s * rho_0 / _safe(b_s, live))[:, None]
                * (z_1[:, None] * w_1[None, :] - z_0[:, None] * r_0[None, :]))
            upd = (active & live)[:, None]
            x_s = torch.where(upd, x_new, x_s)
            s_s = torch.where(upd, s_s_new, s_s)
            r_0 = torch.where(active, r_1, r_0)
            s_0 = torch.where(active, s_new, s_0)
            As = torch.where(active, As_new, As)
            z_m1, z_0 = (torch.where(active, z_0, z_m1),
                         torch.where(active, z_1, z_0))
            rho_0 = torch.where(active, rho_1, rho_0)
            beta_0 = torch.where(active, beta_new, beta_0)
            alpha_0 = torch.where(active, alpha_new, alpha_0)
            delta_1 = torch.where(active, delta_new, delta_1)
            phi_0 = torch.where(active, phi_new, phi_0)
            state.record_(blas.nrm2(r_1), active)
            active = torch.logical_and(active, state.keep_going())
    monitor.absorb_state(state)
    return x_s, monitor
