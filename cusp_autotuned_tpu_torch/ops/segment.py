"""Segmented reductions (counterpart of cusp_autotuned_tpu/ops/segment.py):
a sum by index_add_, and a reduction by any associative operator over
entries sorted by segment, which generalized_spmv takes for a reduce that
has no scatter_reduce mode (parity: cusp/multiply.h:106-120)."""

from __future__ import annotations

import torch


def segment_sum(vals, rows, num_segments):
    """out[r] = sum of vals[e] over the entries e with rows[e] == r."""
    out = vals.new_zeros((num_segments,) + vals.shape[1:])
    return out.index_add_(0, rows.long(), vals)


def segment_reduce(vals, rows, num_segments, reduce_fn):
    """Reduce vals (E, ...) by segment with an associative reduce_fn of two
    tensors, entries sorted by rows (E,); entries with rows >= num_segments
    are dropped.

    Returns (contrib, mask): contrib[r] is the reduction of segment r, in
    entry order, where mask[r]; a segment with no entries has mask False
    and contrib 0.

    An inclusive segmented scan by doubling (Hillis-Steele): after the step
    of span d, entry e holds the reduction of the up to 2d entries of its
    segment that end at e, so the last entry of a segment holds the whole
    segment's after ceil(log2 E) steps; those are scattered to their rows.
    The JAX package runs the same scan as lax.associative_scan."""
    rows = rows.long()
    n = rows.shape[0]
    out_shape = (num_segments,) + vals.shape[1:]
    contrib = vals.new_zeros(out_shape)
    mask = torch.zeros(num_segments, dtype=torch.bool, device=vals.device)
    if n == 0:
        return contrib, mask
    seg_start = torch.ones(n, dtype=torch.bool, device=vals.device)
    seg_start[1:] = rows[1:] != rows[:-1]
    # first[e]: the index of the first entry of e's segment
    idx = torch.arange(n, device=vals.device)
    first = torch.cummax(torch.where(seg_start, idx, 0), 0).values
    scanned = vals
    d = 1
    while d < n:
        joins = (idx[d:] - d) >= first[d:]
        if vals.dim() > 1:
            joins = joins.reshape((-1,) + (1,) * (vals.dim() - 1))
        step = torch.where(joins, reduce_fn(scanned[:-d], scanned[d:]), scanned[d:])
        scanned = torch.cat([scanned[:d], step])
        d *= 2
    seg_end = torch.ones(n, dtype=torch.bool, device=vals.device)
    seg_end[:-1] = rows[:-1] != rows[1:]
    keep = seg_end & (rows < num_segments)
    contrib[rows[keep]] = scanned[keep]
    mask[rows[keep]] = True
    return contrib, mask
