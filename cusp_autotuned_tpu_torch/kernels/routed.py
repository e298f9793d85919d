"""Routed CSR SpMV and SpMM (the SpMM with X staged in shared memory by
column window): the CUDA kernels' wrappers, their plain PyTorch version,
and the planner (the port's `routed` impl).

Replaces the JAX package's routed Pallas kernel, `_routed_kernel`
(cusp_autotuned_tpu/kernels/pallas_routed.py:426), at its SpMV site (:661)
with `csrc/routed_spmv.cu` and at its SpMM site (:709) with
`csrc/routed_spmm.cu`.  On the TPU the rail routes x through 16,384-column
windows with in-lane takes.  Here the SpMV kernel walks the rows as
`csrc/rail_rows.cuh` says (a lane a row of at most SHORT_ROW entries, the
warp's lanes loading the entries together, a warp for each longer row of
`long_rows`) and reads every x through L1/L2: staging x in shared memory
lost to that on every matrix measured, so `window` shapes the SpMM plan
alone.  The SpMM kernel keeps the first design: a thread a row, with each
SpMM window that holds at least window / 8 of the row block's entries
staged (`plan_windows`).  Rows longer than hub_cap (the JAX default
max(64, 4 nnz / m)) form the tail, served by the colsort2 hub kernels
(`colsort2.colsort2_hub`) into the same y: y = routed_main(x) +
colsort2_tail(x) as one callable, the tail holding whole rows.  As in the
JAX package, a plan whose tail holds more than half the entries raises
FormatConversionException: the colsort2 rail is the right kernel there.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.colsort2 import (
    auto_hub_cap, colsort2_hub, hub_plain, hub_tensors, long_rows,
    plan_hub,
)
from cusp_autotuned_tpu_torch.kernels.dia import _scale, promoted
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

WINDOW = 16384                     # columns of a window: 64 KB of f32 x
WINDOWS = (4096, 8192, 16384)      # the `window` axis: 16-64 KB of f32 x
STAGE_MIN_FILL = 1 / 8             # SpMM: stage a window holding >= window / 8 entries
MAX_TAIL = 0.5                     # the JAX rail's refusal: tail > half the entries


def spmm_window(window, acc_dtype):
    """Rows of X in an SpMM window: a window and a 32-column tile of X
    together take at most 128 KB of shared memory."""
    return window // (16 if acc_dtype.itemsize <= 4 else 32)


def plan_windows(row_of, col, m, n, rows_per_block, window):
    """(win_ptr, win_ids) int32: for each block of `rows_per_block` rows,
    the ascending windows of `window` columns that hold at least
    STAGE_MIN_FILL * window of its entries (row_of, col: the entries the
    kernel walks)."""
    nrb = -(-m // rows_per_block)
    nw = max(1, -(-n // window))
    key = (row_of // rows_per_block) * nw + col // window
    if nrb * nw <= 4 * key.size + (1 << 20):
        counts = np.bincount(key, minlength=nrb * nw)
        cells = np.nonzero(counts >= STAGE_MIN_FILL * window)[0]
    else:
        cells, counts = np.unique(key, return_counts=True)
        cells = cells[counts >= STAGE_MIN_FILL * window]
    win_ptr = np.searchsorted(cells // nw, np.arange(nrb + 1)).astype(np.int32)
    return win_ptr, (cells % nw).astype(np.int32)


def routed_spmv_plain(indptr, col, val, hub, x, num_rows, thr):
    """The plan in PyTorch: each row of at most thr entries summed with a
    gather and an index_add_ (where x is read from does not change the
    sum), then the tail through the hub region's plain version.  x may be
    (n,) or (n, k): this is the plain version of both kernels."""
    x = promoted(val, x)
    m = num_rows
    lengths = torch.diff(indptr).long()
    nnz = int(lengths.sum())
    row = torch.repeat_interleave(torch.arange(m, device=x.device), lengths)
    main = lengths[row] <= thr
    prod = _scale(val[:nnz].to(x.dtype), torch.index_select(x, 0, col[:nnz]))
    y = x.new_zeros((m,) + x.shape[1:]).index_add_(0, row[main], prod[main])
    return hub_plain(col, val, hub, x, y)


def _check(indptr, col, val, hub, plan, x, shape, rank):
    """Raise on what the kernels do not take (plan: the kernel's own index
    tensors, the SpMV's long rows or the SpMM's windows)."""
    m, n = shape
    tensors = (indptr, col, val, *hub, *plan)
    if not all(t.device == x.device for t in tensors) or x.device.type != "cuda":
        raise InvalidInputException(
            f"routed kernel needs the plan's tensors and x on one CUDA device "
            f"(got {indptr.device}, {col.device}, {val.device}, {x.device})")
    if val.dtype not in _build.STORAGE or x.dtype != _build.STORAGE[val.dtype][1]:
        raise InvalidInputException(
            f"routed kernel takes f32/bf16 values with f32 x, or f64 with f64 "
            f"(got {val.dtype} values, {x.dtype} x)")
    if not all(t.dtype == torch.int32 for t in (indptr, col, *hub, *plan)):
        raise InvalidInputException("the routed plan's index tensors must be int32")
    if (indptr.shape != (m + 1,) or col.shape != val.shape or x.dim() != rank
            or x.shape[0] != n or (rank == 2 and x.shape[1] < 1)):
        raise InvalidInputException(
            f"shape mismatch: indptr {tuple(indptr.shape)}, col "
            f"{tuple(col.shape)}, val {tuple(val.shape)}, x {tuple(x.shape)}, "
            f"matrix {shape}")
    if not all(t.is_contiguous() for t in tensors + (x,)):
        raise InvalidInputException("routed kernel needs contiguous tensors")


def routed_spmv(arrays, x, shape, thr, window, block=_build.DEFAULT_BLOCK):
    """y = A @ x through the routed plan `arrays` (build_routed's).  On CPU
    tensors this is the plain version; on CUDA tensors it launches the routed kernel and,
    where the plan has a tail, the colsort2 hub pair into the same y (a 2-D
    x goes to routed_spmm), and raises on what the kernels do not take."""
    if x.dim() == 2:
        return routed_spmm(arrays, x, shape, thr, window, block)
    if x.dim() != 1:
        raise NotImplementedException(
            "the routed kernels take x of shape (n,) or (n, k)")
    a = arrays
    m, n = shape
    if x.device.type == "cpu" and a["val"].device.type == "cpu":
        return routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"], x, m, thr)
    _check(a["indptr"], a["col"], a["val"], a["hub"], (a["long"],), x, shape, 1)
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        _build.launch("cusp_routed_spmv", a["val"].dtype, x.device, a["indptr"],
                      a["col"], a["val"], x, y, m, thr, a["long"],
                      a["long"].numel(), block)
        routed_spmv.launches += 1
        colsort2_hub(a["col"], a["val"], a["hub"], x, y, block)
    return y


routed_spmv.launches = 0


def routed_spmm(arrays, x, shape, thr, window, block=_build.DEFAULT_BLOCK):
    """Y = A @ X through the routed plan for a dense row-major block X
    (n, k): the plain version on CPU tensors; on CUDA tensors the routed
    SpMM kernel over the plan's SpMM windows and the colsort2 SpMM hub pair
    for the tail."""
    a = arrays
    m, n = shape
    if x.device.type == "cpu" and a["val"].device.type == "cpu":
        return routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"], x, m, thr)
    _check(a["indptr"], a["col"], a["val"], a["hub"], a["windows"], x, shape, 2)
    k = x.shape[1]
    y = torch.empty((m, k), dtype=x.dtype, device=x.device)
    if m:
        win_ptr, win_ids = a["windows"]
        _build.launch("cusp_routed_spmm", a["val"].dtype, x.device, a["indptr"],
                      a["col"], a["val"], x, y, m, n, k, thr, win_ptr, win_ids,
                      spmm_window(window, x.dtype), block)
        routed_spmm.launches += 1
        colsort2_hub(a["col"], a["val"], a["hub"], x, y, block)
    return y


routed_spmm.launches = 0


def build_routed(A, config):
    """Plan A for the routed kernels: its CSR form with the columns of each
    row in ascending order (other formats converted, unsorted rows sorted on
    the host), rows above hub_cap (0: max(64, 4 nnz / m), the JAX default)
    in the colsort2 tail, the rows of more than SHORT_ROW entries below it
    listed for a warp each, and SpMM windows of spmm_window(window) rows of
    X (window: 4096 to 16384 columns, default 16384) listed per block of
    `block_size` rows (plan_windows), values in the storage dtype that
    `value_dtype` names.  The JAX
    builder's TPU keys (vrow_planes, vrow_span, win_group, pack8, pack16,
    stream_x, spmm_kb, scatter_dot and the tail_* keys) are ignored.  An
    empty matrix, or a tail of more than half the entries, raises
    FormatConversionException."""
    if A.dtype.is_complex:
        raise NotImplementedException("routed kernel supports real dtypes only")
    window = int(config.get("window") or WINDOW)
    if window not in WINDOWS:
        raise NotImplementedException(f"window must be one of {WINDOWS}")
    block = _build.block_size(config)
    if A.format != "csr":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        A = convert(A, "csr")
    if A.nnz == 0:
        raise FormatConversionException("empty matrix — use the default path")
    m, n = A.shape
    nnz = A.nnz
    indptr = host_array(A.indptr).astype(np.int64)
    lengths = np.diff(indptr)
    hub_cap = int(config.get("hub_cap") or 0) or auto_hub_cap(nnz, m)
    is_hub = lengths > hub_cap
    n_tail = int(lengths[is_hub].sum())
    if n_tail > MAX_TAIL * nnz:
        raise FormatConversionException(
            f"routed plan left {n_tail}/{nnz} entries in the tail (rows above "
            f"hub_cap {hub_cap}) — pattern unsuited to the routed rail (use "
            f"colsort2)")
    col = host_array(A.col[:nnz]).astype(np.int64)
    row_of = np.repeat(np.arange(m, dtype=np.int64), lengths)
    order = None
    if nnz > 1 and np.any((np.diff(col) < 0) & (row_of[1:] == row_of[:-1])):
        order = np.lexsort((col, row_of))           # columns ascending per row
        col = col[order]
    main = ~is_hub[row_of]
    acc = _build.STORAGE.get(A.val.dtype, (None, A.val.dtype))[1]
    spmm_win = plan_windows(row_of[main], col[main], m, n, block,
                            spmm_window(window, acc))
    long = long_rows(indptr, hub_cap)
    val = A.val[:nnz]
    if order is not None:
        val = val[torch.from_numpy(order).to(val.device)]
    device = A.device
    arrays = {"indptr": A.indptr,
              "col": torch.from_numpy(col.astype(np.int32)).to(device),
              "val": val.to(plan_value_dtype(config, A.dtype)).contiguous(),
              "hub": hub_tensors(plan_hub(indptr, np.nonzero(is_hub)[0]), device),
              "long": torch.from_numpy(long).to(device),
              "windows": tuple(torch.from_numpy(w).to(device) for w in spmm_win)}
    shape = A.shape

    def apply(arrays, x):
        return routed_spmv(arrays, x, shape, hub_cap, window, block)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    fn.plan_stats = {"impl": "routed", "window": window, "hub_cap": hub_cap,
                     "tail": n_tail, "nnz": nnz,
                     "long_rows": int(long.size),
                     "staged_spmm_windows": int(spmm_win[1].size)}
    return fn
