"""Row-binned CSR SpMV and SpMM: the CUDA kernels' wrappers, their plain
PyTorch version, and the planner.

Replaces the JAX package's row-lane-binned Pallas kernels at their SpMV
sites, `_binned_kernel` (cusp_autotuned_tpu/kernels/pallas_binned.py:193)
and `_streamed_kernel` (:274), with one kernel, `csrc/binned_spmv.cu`: the
rows binned by length into three classes, each walked in row order as
`csrc/rail_rows.cuh` walks the rails' rows (a lane a row of at most
SHORT_ROW entries, a warp a longer row, a block a row longer than
`hub_cap`, in place of the JAX segment-sum spill); the plan lists the warp
and block rows, longest first (`spmv_rows`).  Its SpMM site,
`_binned_spmm_kernel` (:229, and :274 at K > 0), becomes
`csrc/binned_spmm.cu`: the colsort2 and routed SpMMs' row walk
(`csrc/rail_spmm.cuh`, one plane, `spmm_schedule`'s C columns a lane)
over the rows of at most `spmm_cap` entries in the order of the bins that
`plan_bins` sorts them into, the bins of most lanes a row first (by
length, or row order with a fixed `threads_per_row`), then the colsort2
hub pair (`colsort2.colsort2_hub`) for the longer rows, into the same Y.
`spmm_cap` is hub_cap, or the rails' threshold max(64, 4 nnz / m) where
that is lower: the walk gives each row one team, a serial chain that the
warp's other teams wait on, so the long rows go to the hub pair's virtual
rows, as the routed SpMM sends them.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.colsort2 import (
    auto_hub_cap, colsort2_hub, hub_tensors, long_rows, plan_hub,
)
from cusp_autotuned_tpu_torch.kernels.dia import (
    _scale, alignment, promoted, spmm_schedule,
)
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

GROUPS = (1, 2, 4, 8, 16, 32)      # lanes per row of the sub-warp bins
HUB_CAP = 1024                     # longer rows get a block each in the SpMV
                                   # and the hub pair in the SpMM
ENTRIES_PER_LANE = 4               # the length binning's target


def plan_bins(indptr, threads_per_row=0, hub_cap=HUB_CAP):
    """(perm, bins) for host CSR offsets: `perm` lists the rows bin by bin,
    and `bins` holds one (row_start, count, group) per non-empty bin, group
    0 (the rows above hub_cap) last.  threads_per_row 0 bins by length: the
    fewest lanes that leave each at most ENTRIES_PER_LANE entries.  The
    SpMM walks the bins' rows (spmm_walk), a team a row, so the bins choose
    which rows share a warp."""
    lengths = np.diff(np.asarray(indptr, dtype=np.int64))
    if threads_per_row:
        group = np.full(lengths.shape, int(threads_per_row), np.int64)
    else:
        need = np.maximum(-(-lengths // ENTRIES_PER_LANE), 1)
        group = np.minimum(1 << np.ceil(np.log2(need)).astype(np.int64), 32)
    group[lengths > hub_cap] = 0
    order = (*GROUPS, 0)                 # bin order: sub-warp groups, then hubs
    rank_of = np.zeros(33, np.int64)
    rank_of[list(order)] = np.arange(len(order))
    rank = rank_of[group]
    perm = np.argsort(rank, kind="stable").astype(np.int32)
    counts = np.bincount(rank, minlength=len(order))
    starts = np.cumsum(counts) - counts
    bins = [(int(starts[r]), int(counts[r]), order[r])
            for r in range(len(order)) if counts[r]]
    return perm, np.asarray(bins, dtype=np.int32).reshape(-1, 3)


def spmv_rows(indptr, hub_cap=HUB_CAP):
    """(long, hubs) int32 for host CSR offsets: the rows the SpMV kernel
    gives a warp (more than SHORT_ROW entries, at most hub_cap) and a block
    (more than hub_cap), each longest first."""
    lengths = np.diff(np.asarray(indptr, dtype=np.int64))
    long = long_rows(indptr, hub_cap)
    hubs = np.flatnonzero(lengths > hub_cap)
    return tuple(rows[np.argsort(-lengths[rows], kind="stable")].astype(np.int32)
                 for rows in (long, hubs))


def spmm_walk(indptr, perm, bins, cap):
    """(rows, bounds) int32 of the SpMM walk for host CSR offsets: the rows
    of at most cap entries, bin by bin from the last bin (most lanes a row)
    to the first, each bin in perm's order; bounds (rows, 2) their entries'
    [start, stop), the kernel's one load a row."""
    indptr = np.asarray(indptr, dtype=np.int64)
    lengths = np.diff(indptr)
    parts = [np.zeros(0, np.int64)]
    for start, count, _ in reversed(np.asarray(bins).tolist()):
        rows = perm[start:start + count]
        parts.append(rows[lengths[rows] <= cap])
    rows = np.concatenate(parts)
    bounds = np.stack([indptr[rows], indptr[rows + 1]], 1)
    return rows.astype(np.int32), bounds.astype(np.int32)


def binned_spmv_plain(indptr, col, val, perm, bins, x, num_rows):
    """The plan walked bin by bin in PyTorch: each bin's rows gather their
    entries and add them up with an index_add_, accumulated in the promoted
    type of val and x.  A row that no bin lists stays NaN, so a broken plan
    cannot pass.  x may be (n,) or (n, k): this is the plain version of both
    kernels."""
    x = promoted(val, x)
    y = x.new_full((num_rows,) + x.shape[1:], float("nan"))
    for start, count, _ in bins.tolist():
        rows = perm[start:start + count].long()
        lo, hi = indptr[rows].long(), indptr[rows + 1].long()
        lens = hi - lo
        seg = torch.repeat_interleave(torch.arange(count, device=x.device), lens)
        pos = (torch.arange(int(lens.sum()), device=x.device)
               + torch.repeat_interleave(lo - (torch.cumsum(lens, 0) - lens), lens))
        prod = _scale(val[pos].to(x.dtype), torch.index_select(x, 0, col[pos]))
        y[rows] = x.new_zeros((count,) + x.shape[1:]).index_add_(0, seg, prod)
    return y


def _check(arrays, x, shape, rank):
    """Raise on what the kernels do not take (arrays: build_binned's)."""
    m, n = shape
    indptr, col, val, perm, bins = (arrays[k] for k in
                                    ("indptr", "col", "val", "perm", "bins"))
    lists = (indptr, col, val, perm, *arrays["spmv_rows"], *arrays["walk"],
             *arrays["hub"])
    if not all(t.device == x.device for t in lists) or x.device.type != "cuda" \
            or bins.device.type != "cpu":
        raise InvalidInputException(
            f"binned kernel needs indptr, col, val, perm, the SpMV's row lists, "
            f"the SpMM's walk and hub region and x on one CUDA device and bins on "
            f"the host (got {indptr.device}, {col.device}, {val.device}, "
            f"{perm.device}, {x.device}; bins {bins.device})")
    if val.dtype not in _build.STORAGE or x.dtype != _build.STORAGE[val.dtype][1]:
        raise InvalidInputException(
            f"binned kernel takes f32/bf16 values with f32 x, or f64 with f64 "
            f"(got {val.dtype} values, {x.dtype} x)")
    if not all(t.dtype == torch.int32 for t in lists[:2] + lists[3:] + (bins,)):
        raise InvalidInputException(
            "indptr, col, perm, bins, the row lists, the walk and the hub region "
            "must be int32")
    walk, bounds = arrays["walk"]
    if (indptr.shape != (m + 1,) or perm.shape != (m,) or x.dim() != rank
            or x.shape[0] != n or (rank == 2 and x.shape[1] < 1)
            or col.shape != val.shape or bins.dim() != 2 or bins.shape[1] != 3
            or bounds.shape != (walk.numel(), 2)):
        raise InvalidInputException(
            f"shape mismatch: indptr {tuple(indptr.shape)}, perm "
            f"{tuple(perm.shape)}, col {tuple(col.shape)}, val "
            f"{tuple(val.shape)}, x {tuple(x.shape)}, bins {tuple(bins.shape)}, "
            f"walk {tuple(walk.shape)} and {tuple(bounds.shape)}, matrix {shape}")
    if not all(t.is_contiguous() for t in lists + (bins, x)):
        raise InvalidInputException("binned kernel needs contiguous tensors")


def binned_spmv(arrays, x, shape, hub_cap, block=_build.DEFAULT_BLOCK):
    """y = A @ x through the plan `arrays` (build_binned's).  On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel (a 2-D x goes to binned_spmm), and raises on what the kernel does
    not take."""
    if x.dim() == 2:
        return binned_spmm(arrays, x, shape, block)
    if x.dim() != 1:
        raise NotImplementedException(
            "the binned kernels take x of shape (n,) or (n, k)")
    a = arrays
    m = shape[0]
    if x.device.type == "cpu" and a["val"].device.type == "cpu":
        return binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"],
                                 a["bins"], x, m)
    _check(a, x, shape, 1)
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        long, hubs = a["spmv_rows"]
        _build.launch("cusp_binned_spmv", a["val"].dtype, x.device, a["indptr"],
                      a["col"], a["val"], x, y, m, hub_cap, long, long.numel(), hubs,
                      hubs.numel(), block)
        binned_spmv.launches += 1
    return y


binned_spmv.launches = 0


def binned_spmm(arrays, x, shape, block=_build.DEFAULT_BLOCK):
    """Y = A @ X through the plan for a dense row-major block X (n, k): the
    plain version on CPU tensors; on CUDA tensors the SpMM walk over the
    plan's walk list (a team of lanes a row, spmm_schedule's C columns a
    lane) and the colsort2 SpMM hub pair for the rows above spmm_cap, and
    raises on what the kernels do not take."""
    a = arrays
    m = shape[0]
    if x.device.type == "cpu" and a["val"].device.type == "cpu":
        return binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"],
                                 a["bins"], x, m)
    _check(a, x, shape, 2)
    k = x.shape[1]
    y = torch.empty((m, k), dtype=x.dtype, device=x.device)
    rows, bounds = a["walk"]
    if rows.numel():
        width, cols, _, team_shift = spmm_schedule(k, alignment(x, y),
                                                   x.element_size())
        _build.launch("cusp_binned_spmm", a["val"].dtype, x.device, a["col"],
                      a["val"], rows, bounds, rows.numel(), x, y, k, width, cols,
                      team_shift, block)
        binned_spmm.launches += 1
    colsort2_hub(a["col"], a["val"], a["hub"], x, y, block)
    return y


binned_spmm.launches = 0


def build_binned(A, config):
    """Plan A for the binned kernels: its CSR form (other formats converted
    on the host), the SpMV's warp and block rows for `hub_cap` (spmv_rows),
    the row bins for `threads_per_row` and `hub_cap`, the SpMM's walk list
    (spmm_walk) and hub region (the rows above spmm_cap = min(hub_cap,
    max(64, 4 nnz / m)), as colsort2's plan_hub cuts them), values in the
    storage dtype that `value_dtype` names, `block_size` threads per
    block.  An empty matrix raises FormatConversionException (the default
    path serves it), as in the JAX package."""
    if A.dtype.is_complex:
        raise NotImplementedException("binned kernel supports real dtypes only")
    tpr = int(config.get("threads_per_row") or 0)
    if tpr and tpr not in GROUPS:
        raise NotImplementedException(
            f"threads_per_row must be 0 (by length) or one of {GROUPS}")
    hub_cap = int(config.get("hub_cap") or HUB_CAP)
    block = _build.block_size(config)
    if A.format != "csr":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        A = convert(A, "csr")
    if A.nnz == 0:
        raise FormatConversionException("empty matrix — use the default path")
    indptr = host_array(A.indptr)
    perm, bins = plan_bins(indptr, tpr, hub_cap)
    rows = spmv_rows(indptr, hub_cap)
    spmm_cap = min(hub_cap, auto_hub_cap(A.nnz, A.shape[0]))
    walk = spmm_walk(indptr, perm, bins, spmm_cap)
    spmm_hubs = np.flatnonzero(np.diff(np.asarray(indptr, np.int64)) > spmm_cap)
    arrays = {"indptr": A.indptr, "col": A.col,
              "val": A.val.to(plan_value_dtype(config, A.dtype)).contiguous(),
              "perm": torch.from_numpy(perm).to(A.device),
              "bins": torch.from_numpy(bins),
              "spmv_rows": tuple(torch.from_numpy(r).to(A.device) for r in rows),
              "walk": tuple(torch.from_numpy(t).to(A.device) for t in walk),
              "hub": hub_tensors(plan_hub(indptr, spmm_hubs), A.device)}
    shape = A.shape

    def apply(arrays, x):
        return binned_spmv(arrays, x, shape, hub_cap, block)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    fn.plan_stats = {"impl": "binned", "bins": bins.tolist(), "hub_cap": hub_cap,
                     "long_rows": int(rows[0].size), "hub_rows": int(rows[1].size),
                     "spmm_cap": spmm_cap, "spmm_hub_rows": int(spmm_hubs.size)}
    return fn
