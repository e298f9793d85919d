"""Maximal independent set, Luby-style with random priorities (counterpart
of cusp_autotuned_tpu/graph/mis.py).

Parity: cusp::graph::maximal_independent_set(G, stencil, k = 1): MIS(k),
the selected vertices pairwise more than k hops apart and every vertex
within k hops of one of them.  k = 2 roots the AMG MIS aggregation.  The
priorities are the JAX package's, np.random.RandomState(seed).permutation(n)
+ 1, so one seed selects the same set in both packages.  A round is 2k
max-semiring products on G's device; the host reads the stop flag after
each (graph/traversal.py).
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.graph.traversal import (
    ID_DTYPE, _neighbor_max, _until, strip_diagonal,
)

UNDECIDED, IN_SET, REMOVED = 0, 1, 2


def priorities(n: int, seed: int, device) -> torch.Tensor:
    """Unique random priorities 1..n, the JAX package's draw."""
    perm = np.random.RandomState(seed).permutation(n) + 1
    return torch.as_tensor(perm, dtype=ID_DTYPE, device=device)


def _khop_max(A, vals, k: int):
    """The max of vals over the <= k-hop neighbourhood (self excluded)."""
    out = _neighbor_max(A, vals)
    reach = out
    for _ in range(k - 1):
        reach = torch.maximum(reach, _neighbor_max(A, reach))
        out = torch.maximum(out, reach)
    return out


def maximal_independent_set(G, k: int = 1, seed: int = 0):
    """(count, stencil): stencil[v] = 1 where v is selected, int32 on G's
    device."""
    G = strip_diagonal(G)
    k = int(k)
    priority = priorities(G.num_rows, seed, G.device)
    state = torch.zeros(G.num_rows, dtype=torch.int32, device=G.device)

    def step(st):
        active = st == UNDECIDED
        vals = torch.where(active, priority, 0)
        # k >= 2 hop paths revisit the start vertex, so the k-hop max holds
        # the own priority; with unique priorities, equality marks the
        # local maximum
        selected = active & (vals >= _khop_max(G, vals, k))
        near = _khop_max(G, selected.to(ID_DTYPE), k) > 0
        st = torch.where(selected, IN_SET, st)
        return torch.where(near & (st == UNDECIDED), REMOVED, st)

    state, _ = _until(step, state, lambda st: ~(st == UNDECIDED).any())
    stencil = (state == IN_SET).to(torch.int32)
    return int(stencil.sum()), stencil
