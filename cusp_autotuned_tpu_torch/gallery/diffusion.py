"""Anisotropic rotated diffusion operators (counterpart of
cusp_autotuned_tpu/gallery/diffusion.py; parity target
cusp/gallery/diffusion.h and detail/diffusion.inl, the same FE/FD
coefficients), on the port's stencil generator."""

from __future__ import annotations

import math

import torch

from cusp_autotuned_tpu_torch.gallery.stencil import generate_matrix_from_stencil
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

FE = "FE"
FD = "FD"


def diffusion(m, n, eps=1e-5, theta=math.pi / 4, method=FE,
              format="csr", dtype=torch.float32, device=None):
    C = math.cos(theta)
    S = math.sin(theta)
    CC, SS, CS = C * C, S * S, C * S

    if method == FE:
        a = ((-1 * eps - 1) * CC + (-1 * eps - 1) * SS + (3 * eps - 3) * CS) / 6
        b = ((2 * eps - 4) * CC + (-4 * eps + 2) * SS) / 6
        c = ((-1 * eps - 1) * CC + (-1 * eps - 1) * SS + (-3 * eps + 3) * CS) / 6
        d = ((-4 * eps + 2) * CC + (2 * eps - 4) * SS) / 6
        e = ((8 * eps + 8) * CC + (8 * eps + 8) * SS) / 6
    elif method == FD:
        a = 0.5 * (eps - 1.0) * CS
        b = -(eps * SS + CC)
        c = -a
        d = -(eps * CC + SS)
        e = 2.0 * (eps + 1.0)
    else:
        raise InvalidInputException("unrecognized discretization method")

    stencil = [((-1, -1), a), ((0, -1), b), ((1, -1), c),
               ((-1, 0), d), ((0, 0), e), ((1, 0), d),
               ((-1, 1), c), ((0, 1), b), ((1, 1), a)]
    return generate_matrix_from_stencil(stencil, (m, n), format, dtype, device)
