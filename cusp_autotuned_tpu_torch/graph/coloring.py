"""Greedy vertex colouring by rounds of independent sets, Jones-Plassmann
(counterpart of cusp_autotuned_tpu/graph/coloring.py).

Parity: cusp::graph::vertex_coloring(G, colors) -> the number of colours;
multicolour Gauss-Seidel colours its matrix with it
(cusp/relaxation/detail/gauss_seidel.inl:40-53).  Round c colours c every
uncoloured vertex whose priority (graph/mis.py's draw) beats those of its
uncoloured neighbours: one max-semiring product on G's device.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.graph.mis import priorities
from cusp_autotuned_tpu_torch.graph.traversal import _neighbor_max, _until, strip_diagonal


def vertex_coloring(G, seed: int = 0):
    """(number of colours, colours int32 on G's device), adjacent vertices
    coloured differently."""
    G = strip_diagonal(G)
    priority = priorities(G.num_rows, seed, G.device)
    colors = torch.full((G.num_rows,), -1, dtype=torch.int32, device=G.device)

    def step(state):
        cols, c = state
        active = cols < 0
        vals = torch.where(active, priority, 0)
        selected = active & (vals > _neighbor_max(G, vals))
        return torch.where(selected, c, cols), c + 1

    # every round colours the uncoloured vertex of highest priority at
    # least, so the count of rounds is the count of colours
    (colors, count), _ = _until(step, (colors, 0), lambda s: ~(s[0] < 0).any())
    return count, colors
