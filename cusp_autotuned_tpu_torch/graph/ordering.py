"""Matrix orderings: the pseudo-peripheral vertex and symmetric RCM
(counterpart of cusp_autotuned_tpu/graph/ordering.py).

Parity: cusp::graph::pseudo_peripheral_vertex and symmetric_rcm, a
permutation that reorders a matrix symmetrically.  Set-up work on the host,
as in the JAX package: both run in the port's native code
(native/ordering.cpp, a copy of the repository's `native/ordering.cpp`),
which raises where it cannot be built.  The Python BFS below is the plain
version the tests hold the native code against.
"""

from __future__ import annotations

import numpy as np

from cusp_autotuned_tpu_torch.formats.permutation import PermutationMatrix, permutation_matrix


def _adjacency(G):
    """G's CSR offsets and columns on the host."""
    from cusp_autotuned_tpu_torch.ops.convert import _indptr, coo_arrays
    row, col, _, (m, _) = coo_arrays(G)
    return _indptr(row, m), col


def pseudo_peripheral_vertex(G) -> int:
    """A vertex of (near-)maximal eccentricity, by repeated BFS
    (George-Liu)."""
    from cusp_autotuned_tpu_torch import native
    return native.pseudo_peripheral(*_adjacency(G))


def symmetric_rcm(G) -> PermutationMatrix:
    """The reverse Cuthill-McKee permutation P on G's device; P A P^T
    (A[perm][:, perm]) has a narrow band, so an unstructured matrix becomes
    viable as DIA."""
    from cusp_autotuned_tpu_torch import native
    return permutation_matrix(native.rcm(*_adjacency(G)), device=G.device)


# -- the plain versions -------------------------------------------------------

def bfs_levels_host(indptr, col, src, n):
    levels = np.full(n, -1, np.int64)
    levels[src] = 0
    frontier = [src]
    lvl = 0
    while frontier:
        nxt = []
        for u in frontier:
            for v in col[indptr[u]: indptr[u + 1]]:
                if levels[v] < 0:
                    levels[v] = lvl + 1
                    nxt.append(v)
        frontier = nxt
        lvl += 1
    return levels


def pseudo_peripheral_host(indptr, col) -> int:
    """pseudo_peripheral_vertex in Python (the JAX package's fallback)."""
    n = len(indptr) - 1
    degrees = np.diff(indptr)
    x = int(np.argmin(degrees))
    ecc = -1
    while True:
        levels = bfs_levels_host(indptr, col, x, n)
        far = levels.max()
        if far <= ecc:
            return x
        ecc = far
        last = np.nonzero(levels == far)[0]
        x = int(last[np.argmin(degrees[last])])


def rcm_host(indptr, col) -> np.ndarray:
    """symmetric_rcm's permutation in Python (the JAX package's fallback)."""
    n = len(indptr) - 1
    degrees = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = []
    pending = [pseudo_peripheral_host(indptr, col)]
    while len(order) < n:
        if not pending:
            rest = np.nonzero(~visited)[0]
            pending = [int(rest[np.argmin(degrees[rest])])]
        queue = []
        for u in pending:
            if visited[u]:
                continue
            visited[u] = True
            queue.append(u)
        pending = []
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            order.append(u)
            nbrs = [v for v in col[indptr[u]: indptr[u + 1]] if not visited[v]]
            nbrs.sort(key=lambda v: degrees[v])
            for v in nbrs:
                visited[v] = True
                queue.append(v)
    return np.asarray(order[::-1], np.int32)
