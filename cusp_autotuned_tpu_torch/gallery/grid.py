"""Grid-graph adjacency matrices (counterpart of
cusp_autotuned_tpu/gallery/grid.py; parity target cusp/gallery/grid.h and
detail/grid.inl), on the port's stencil generator."""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.gallery.stencil import generate_matrix_from_stencil


def grid2d(m, n, format="csr", dtype=torch.float32, device=None):
    """The 4-neighbour adjacency of an m x n grid (unit entries)."""
    stencil = [((0, -1), 1), ((-1, 0), 1), ((1, 0), 1), ((0, 1), 1)]
    return generate_matrix_from_stencil(stencil, (m, n), format, dtype, device)


def grid3d(m, n, l, format="csr", dtype=torch.float32, device=None):
    """The 26-neighbour adjacency of an m x n x l grid (unit entries)."""
    stencil = [((i, j, k), 1)
               for k in (-1, 0, 1) for j in (-1, 0, 1) for i in (-1, 0, 1)
               if not (i == 0 and j == 0 and k == 0)]
    return generate_matrix_from_stencil(stencil, (m, n, l), format, dtype, device)
