"""Aggregation (counterpart of cusp_autotuned_tpu/precond/aggregation/
aggregate.py; parity: cusp/precond/aggregation/system/detail/generic/
standard_aggregate.h): the greedy three-pass aggregation over the strength
graph, through the port's native aggregator, the MIS(2)-rooted
aggregation, and the grid-blocked aggregation of raster-ordered 2-D
stencils.  Each returns (aggregate id per row, root row per aggregate) as
host int32 arrays."""

from __future__ import annotations

import numpy as np


def standard_aggregate(C):
    """Vanek's three-pass greedy aggregation over the strength graph C,
    by the native aggregator (native/aggregate.cpp)."""
    from cusp_autotuned_tpu_torch import native
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    S = to_scipy(C).tocsr()
    return native.standard_aggregate(S.indptr, S.indices)


def detect_grid(A, max_radius: int = 3):
    """Infer a 2-D grid (ny, nx) in raster (row-major) order from A's
    diagonals, or None.

    A grid-ordered stencil matrix has every nonzero at offset
    o = col - row = dy * nx + dx with small |dy|, |dx|.  nx is the offset
    above max_radius that holds the most nonzeros, validated by requiring
    every offset to decompose within the radius and every entry at
    (y, x) -> (y + dy, x + dx) to keep x + dx inside [0, nx): a 1-D
    multi-band chain (offsets {-4, -1, 0, 1, 4}) decomposes arithmetically
    but has +1 entries at x == nx - 1, and is rejected.  The JAX package
    reads its cached band form; this reads the stored entries, with the
    same decisions (no grid past MAX_BAND diagonals)."""
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    from cusp_autotuned_tpu_torch.precond.aggregation.structured_rap import MAX_BAND
    row, col, val, (n, m) = coo_arrays(A)
    if n != m or row.size == 0:
        return None
    off = col.astype(np.int64) - row.astype(np.int64)
    offs, inv = np.unique(off, return_inverse=True)
    if offs.size > MAX_BAND or offs.size > (2 * max_radius + 1) ** 2:
        return None      # a radius-r stencil has at most (2r+1)^2 offsets
    nonzero = val != 0
    counts = np.bincount(inv[nonzero], minlength=offs.size)
    big_mask = offs > max_radius
    if not big_mask.any():
        return None
    nx = int(offs[big_mask][np.argmax(counts[big_mask])])
    if nx <= max_radius or n % nx:
        return None
    ny = n // nx
    if ny < 2 or nx < 2:
        return None
    dy = np.rint(offs / nx).astype(np.int64)
    dx = offs - dy * nx
    if (np.abs(dy) > max_radius).any() or (np.abs(dx) > max_radius).any():
        return None
    # x + dx must stay on the grid for every nonzero entry (y + dy then
    # stays in range too, since the column is in [0, n))
    x = row[nonzero].astype(np.int64) % nx + dx[inv[nonzero]]
    if np.any((x < 0) | (x >= nx)):
        return None
    return ny, nx


def structured_aggregate(C, block=(3, 3), grid=None):
    """Grid-blocked aggregation: when the operator is a raster-ordered 2-D
    stencil (detect_grid), aggregate exact py x px blocks with coarse ids
    in coarse raster order.

    The payoff is the apply structure: the tentative prolongator becomes
    w * upsample(e) (pure broadcast/reshape — no gather) and its transpose
    a reshape/fold-sum, so the AMG R/P applies stream instead of
    gathering; the Galerkin coarse operator comes out
    banded on the (nby, nbx) raster grid, so the structure recurses down
    the hierarchy.  Raises ValueError when no grid is detected (callers
    using 'auto' fall back to standard_aggregate).  py = px = 3 matches the
    smoothed-aggregation diameter-3 aggregate ideal (Vanek)."""
    g = grid or detect_grid(C)
    if g is None:
        raise ValueError("no raster grid structure detected")
    ny, nx = g
    py, px = block
    nby, nbx = -(-ny // py), -(-nx // px)
    yy, xx = np.divmod(np.arange(ny * nx, dtype=np.int64), nx)
    agg = (yy // py) * nbx + (xx // px)
    # root = the first (top-left) member of each block
    by, bx = np.divmod(np.arange(nby * nbx, dtype=np.int64), nbx)
    roots = (by * py) * nx + bx * px
    return agg.astype(np.int32), roots.astype(np.int32)


def mis_aggregate(C, seed: int = 0):
    """MIS(2)-rooted aggregation (parity: generic/mis_aggregate.h:117-197):
    the roots are an MIS(2) of the strength graph C, drawn on C's device
    (graph.maximal_independent_set); in each of two rounds every vertex
    still unassigned joins the aggregate of its first neighbour, in CSR
    column order, that the previous round had assigned (every vertex is
    within two hops of a root); stragglers become singletons.  The JAX
    package runs the rounds as a Python loop over the vertices; here each
    round is a few numpy passes over the entries, with the same outcome."""
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    from cusp_autotuned_tpu_torch.formats.base import host_array
    from cusp_autotuned_tpu_torch.graph.mis import maximal_independent_set
    n = C.num_rows
    _, stencil = maximal_independent_set(C, k=2, seed=seed)
    roots = np.nonzero(host_array(stencil))[0]
    S = to_scipy(C).tocsr()
    col = np.asarray(S.indices)
    row = np.repeat(np.arange(n), np.diff(S.indptr))
    agg = np.full(n, -1, np.int64)
    agg[roots] = np.arange(roots.size)
    for _ in range(2):
        hit = (agg[row] == -1) & (agg[col] != -1)
        # entries run in row order, so a row's first hit is its first index
        joined, first = np.unique(row[hit], return_index=True)
        newagg = agg.copy()
        newagg[joined] = agg[col[hit][first]]
        agg = newagg
    stray = np.nonzero(agg == -1)[0]
    if stray.size:
        agg[stray] = np.arange(stray.size) + roots.size
        roots = np.concatenate([roots, stray])
    return agg.astype(np.int32), roots.astype(np.int32)
