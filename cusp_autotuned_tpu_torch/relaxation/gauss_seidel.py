"""Multicolour Gauss-Seidel relaxation (counterpart of
cusp_autotuned_tpu/relaxation/gauss_seidel.py).

Parity: cusp::relaxation::gauss_seidel: set-up colours the matrix's graph
and groups the rows by colour (relaxation/detail/gauss_seidel.inl:40-53);
a sweep visits the colour classes in order and updates every row of a
class at once.  Rows of one colour do not touch each other, so the batched
update is exact Gauss-Seidel in colour order.  Each colour is one SpMV
through the operator the sweep is given (on the card a planned operator,
so a hand kernel) and a masked update:

    x <- where(colors == c, x + D^-1 (b - A x), x)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cusp_autotuned_tpu_torch.ops.format_utils import inverse_diagonal_host
from cusp_autotuned_tpu_torch.ops.multiply import multiply

FORWARD = "forward"
BACKWARD = "backward"
SYMMETRIC = "symmetric"


@dataclasses.dataclass(frozen=True)
class GaussSeidel:
    diag_inv: torch.Tensor          # D^-1, 0 where the diagonal is 0
    colors: torch.Tensor            # (n,) int32 colour class of each row
    num_colors: int = 1
    default_direction: str = FORWARD
    shape: Tuple[int, int] = (0, 0)

    format = "gauss_seidel_relaxation"

    def _one_color(self, A, b, x, c):
        upd = x + self.diag_inv * (b - multiply(A, x))
        return torch.where(self.colors == c, upd, x)

    def __call__(self, A, b, x, direction: str | None = None):
        direction = direction or self.default_direction
        order = list(range(self.num_colors))
        if direction == BACKWARD:
            order = order[::-1]
        elif direction == SYMMETRIC:
            order = order + order[::-1]
        for c in order:
            x = self._one_color(A, b, x, c)
        return x


def gauss_seidel(A, default_direction: str = FORWARD, seed: int = 0) -> GaussSeidel:
    """Colour A's graph (graph.vertex_coloring, on A's device) and take D^-1."""
    from cusp_autotuned_tpu_torch.graph.coloring import vertex_coloring
    ncolors, colors = vertex_coloring(A, seed=seed)
    dinv = torch.from_numpy(inverse_diagonal_host(A)).to(device=A.device,
                                                         dtype=A.dtype)
    return GaussSeidel(diag_inv=dinv, colors=colors, num_colors=int(ncolors),
                       default_direction=default_direction, shape=tuple(A.shape))
