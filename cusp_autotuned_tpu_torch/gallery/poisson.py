"""Poisson stencil matrices (counterpart of cusp_autotuned_tpu/gallery/poisson.py;
the stencil coefficients of cusp/gallery/poisson.h)."""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.gallery.stencil import generate_matrix_from_stencil


def poisson5pt(m, n, format="csr", dtype=torch.float32, device=None):
    stencil = [((0, -1), -1), ((-1, 0), -1), ((0, 0), 4),
               ((1, 0), -1), ((0, 1), -1)]
    return generate_matrix_from_stencil(stencil, (m, n), format, dtype, device)


def poisson9pt(m, n, format="csr", dtype=torch.float32, device=None):
    stencil = [((i, j), 8 if (i == 0 and j == 0) else -1)
               for j in (-1, 0, 1) for i in (-1, 0, 1)]
    return generate_matrix_from_stencil(stencil, (m, n), format, dtype, device)
