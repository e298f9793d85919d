"""Virtual-row CSR SpMV and SpMM with a fixed-plane fold: the CUDA kernels'
wrappers, their plain PyTorch version, and the planner (the port's
`colsort2` impl).

Replaces the JAX package's colsort2 Pallas kernel, `_v2_kernel`
(cusp_autotuned_tpu/kernels/pallas_colsort2.py:519), at its SpMV site
(:833) with `csrc/colsort2_spmv.cu` and at its SpMM site (:883) with
`csrc/colsort2_spmm.cu`.  The plan keeps the JAX rail's idea and drops its
TPU slot layout (edge colouring, one-hot MXU scatter, VMEM windows): a row
of at most thr = min(hub_cap, K * V) entries is cut into K = `vrow_planes`
virtual rows of at most V = `vrow_len` entries, plane k holding entries
[k V, (k + 1) V); each plane is summed on its own and the planes fold in
order 0..K-1.  The SpMV kernel walks the main rows as `csrc/rail_rows.cuh`
says: a lane sums a row of at most SHORT_ROW entries, the warp's lanes
loading the rows' entries together, and a warp sums each longer main row
(`long_rows`, planned here).  Longer rows form the hub region: virtual
rows of at most HUB_SPLIT entries, sorted by degree, each summed by a warp
and folded per row in order by a second small kernel.  The SpMM kernels
take X's columns as the DIA SpMM does (kernels/dia.py `spmm_schedule`: C
columns a lane with 16-byte loads, a team of lanes a row), the warp loading
its rows' entries together.  The routed rail rides the hub kernels alone
as its tail (`colsort2_hub`).
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.dia import (
    _scale, alignment, promoted, spmm_schedule,
)
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

K_DEFAULT = 2                      # vrow_planes, as the JAX package's K_DEFAULT
HUB_SPLIT = 128                    # entries per hub virtual row, as the JAX HUB_SPLIT
SHORT_ROW = 32                     # a main row of at most 32 entries: one lane
                                   # (kShort in csrc/rail_rows.cuh)


def auto_hub_cap(nnz, m):
    """The JAX rails' default hub threshold, max(64, 4 nnz / m)
    (pallas_colsort2.py:238-243, pallas_routed.py:189-190)."""
    return int(max(64, 4 * nnz // max(1, m)))


def long_rows(indptr, thr):
    """int32 ids of the main rows that a warp sums alone (rail_rows.cuh):
    more than SHORT_ROW entries and at most thr."""
    lengths = np.diff(np.asarray(indptr, dtype=np.int64))
    return np.nonzero((lengths > SHORT_ROW) & (lengths <= thr))[0].astype(np.int32)


def plan_hub(indptr, hub_rows):
    """The hub region of host CSR offsets for the given hub rows: the rows
    sorted by degree (longest first, as the JAX hub region), each cut into
    virtual rows of at most HUB_SPLIT entries.  Returns int32 arrays (rows,
    ptr, lo, hi): row h's virtual rows are [ptr[h], ptr[h+1]), virtual row
    v covers entries [lo[v], hi[v])."""
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = indptr[hub_rows + 1] - indptr[hub_rows]
    order = np.argsort(-deg, kind="stable")
    rows, deg = hub_rows[order], deg[order]
    per = -(-deg // HUB_SPLIT)
    ptr = np.concatenate([[0], np.cumsum(per)])
    owner = np.repeat(np.arange(rows.size), per)
    lo = indptr[rows][owner] + HUB_SPLIT * (np.arange(ptr[-1]) - ptr[:-1][owner])
    hi = np.minimum(lo + HUB_SPLIT, indptr[rows + 1][owner])
    return tuple(a.astype(np.int32) for a in (rows, ptr, lo, hi))


def plan_colsort2(indptr, K=K_DEFAULT, V=0, hub_cap=0):
    """(thr, V, hub) for host CSR offsets: rows longer than thr =
    min(hub_cap, K V) go to the hub region (plan_hub); hub_cap 0 is the JAX
    default and V 0 is ceil(hub_cap / K), so that thr is hub_cap."""
    indptr = np.asarray(indptr, dtype=np.int64)
    m = indptr.size - 1
    hub_cap = int(hub_cap) or auto_hub_cap(int(indptr[-1]), m)
    V = int(V) or -(-hub_cap // K)
    thr = min(hub_cap, K * V)
    lengths = np.diff(indptr)
    return thr, V, plan_hub(indptr, np.nonzero(lengths > thr)[0])


def hub_plain(col, val, hub, x, y):
    """The hub region in PyTorch: each virtual row's sum, then each hub
    row's virtual rows added in order into y (assigned, so a hub row the
    plan misses keeps what y held).  x may be (n,) or (n, k)."""
    x = promoted(val, x)
    rows, ptr, lo, hi = hub
    if rows.numel() == 0:
        return y
    lens = (hi - lo).long()
    vrow = torch.repeat_interleave(torch.arange(lens.numel(), device=x.device), lens)
    pos = (torch.arange(int(lens.sum()), device=x.device)
           + torch.repeat_interleave(lo.long() - (torch.cumsum(lens, 0) - lens), lens))
    prod = _scale(val[pos].to(x.dtype), torch.index_select(x, 0, col[pos]))
    part = x.new_zeros((lens.numel(),) + x.shape[1:]).index_add_(0, vrow, prod)
    owner = torch.repeat_interleave(torch.arange(rows.numel(), device=x.device),
                                    torch.diff(ptr).long())
    y[rows.long()] = x.new_zeros((rows.numel(),) + x.shape[1:]).index_add_(
        0, owner, part)
    return y


def colsort2_spmv_plain(indptr, col, val, hub, x, num_rows, K, V, thr):
    """The plan in PyTorch: the products of each row of at most thr entries
    summed per plane (plane k: entries [k V, (k + 1) V) of the row), the
    planes added in order, then the hub region.  x may be (n,) or (n, k):
    this is the plain version of both kernels."""
    x = promoted(val, x)
    m = num_rows
    lengths = torch.diff(indptr).long()
    nnz = int(lengths.sum())
    row = torch.repeat_interleave(torch.arange(m, device=x.device), lengths)
    pos = torch.arange(nnz, device=x.device) - indptr[row].long()
    main = lengths[row] <= thr
    slot = torch.div(pos, V, rounding_mode="floor") * m + row
    prod = _scale(val[:nnz].to(x.dtype), torch.index_select(x, 0, col[:nnz]))
    planes = x.new_zeros((K * m,) + x.shape[1:]).index_add_(0, slot[main], prod[main])
    y = planes.reshape((K, m) + x.shape[1:]).sum(0)
    return hub_plain(col, val, hub, x, y)


def _check(indptr, col, val, hub, x, shape, rank):
    """Raise on what the kernels do not take (hub: the hub tables and, for
    the SpMV kernel, the long rows)."""
    m, n = shape
    if not all(t.device == x.device for t in (indptr, col, val, *hub)) \
            or x.device.type != "cuda":
        raise InvalidInputException(
            f"colsort2 kernel needs indptr, col, val, the hub tables and x on "
            f"one CUDA device (got {indptr.device}, {col.device}, {val.device}, "
            f"{x.device})")
    if val.dtype not in _build.STORAGE or x.dtype != _build.STORAGE[val.dtype][1]:
        raise InvalidInputException(
            f"colsort2 kernel takes f32/bf16 values with f32 x, or f64 with f64 "
            f"(got {val.dtype} values, {x.dtype} x)")
    if not all(t.dtype == torch.int32 for t in (indptr, col, *hub)):
        raise InvalidInputException(
            "indptr, col, the hub tables and the long rows must be int32")
    if (indptr.shape != (m + 1,) or col.shape != val.shape or x.dim() != rank
            or x.shape[0] != n or (rank == 2 and x.shape[1] < 1)):
        raise InvalidInputException(
            f"shape mismatch: indptr {tuple(indptr.shape)}, col "
            f"{tuple(col.shape)}, val {tuple(val.shape)}, x {tuple(x.shape)}, "
            f"matrix {shape}")
    if not all(t.is_contiguous() for t in (indptr, col, val, x, *hub)):
        raise InvalidInputException("colsort2 kernel needs contiguous tensors")


def colsort2_hub(col, val, hub, x, y, block=_build.DEFAULT_BLOCK):
    """The hub region's kernels on the card: a warp per hub virtual row,
    then the in-order fold per hub row, writing the hub rows of y in place
    (a 2-D x goes to colsort2_hub_spmm).  Launch-only: its callers, the
    colsort2 wrappers and the routed rail's tail, check the tensors."""
    if x.dim() == 2:
        return colsort2_hub_spmm(col, val, hub, x, y, block)
    rows, ptr, lo, hi = hub
    if rows.numel():
        part = torch.empty(lo.numel(), dtype=x.dtype, device=x.device)
        _build.launch("cusp_colsort2_hub", val.dtype, x.device, col, val, x, lo,
                      hi, lo.numel(), rows, ptr, rows.numel(), part, y, block)
        colsort2_hub.launches += 1
    return y


colsort2_hub.launches = 0


def colsort2_hub_spmm(col, val, hub, x, y, block=_build.DEFAULT_BLOCK):
    """colsort2_hub for a dense block x (n, k): a team of lanes over a tile
    of C-column lanes per hub virtual row (spmm_schedule), then the fold per
    (hub row, column)."""
    rows, ptr, lo, hi = hub
    if rows.numel():
        k = x.shape[1]
        part = torch.empty((lo.numel(), k), dtype=x.dtype, device=x.device)
        width, cols, _, team_shift = spmm_schedule(k, alignment(x, part),
                                                   x.element_size())
        _build.launch("cusp_colsort2_hub_spmm", val.dtype, x.device, col, val, x,
                      lo, hi, lo.numel(), rows, ptr, rows.numel(), part, y, k,
                      width, cols, team_shift, block)
        colsort2_hub_spmm.launches += 1
    return y


colsort2_hub_spmm.launches = 0


def colsort2_spmv(indptr, col, val, hub, long, x, shape, K, V, thr,
                  block=_build.DEFAULT_BLOCK, one_plane=False):
    """y = A @ x through the plan (`long`: the long_rows ids; one_plane: no
    main row is longer than V, which lets the kernel drop its plane
    bookkeeping, with the same sums).  On CPU tensors this is the plain
    version; on CUDA tensors it launches the main kernel and, where the plan
    has hub rows, the hub pair (a 2-D x goes to colsort2_spmm), and raises
    on what the kernels do not take."""
    if x.dim() == 2:
        return colsort2_spmm(indptr, col, val, hub, x, shape, K, V, thr, block)
    if x.dim() != 1:
        raise NotImplementedException(
            "the colsort2 kernels take x of shape (n,) or (n, k)")
    m = shape[0]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return colsort2_spmv_plain(indptr, col, val, hub, x, m, K, V, thr)
    _check(indptr, col, val, hub + (long,), x, shape, 1)
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        _build.launch("cusp_colsort2_spmv", val.dtype, x.device, indptr, col, val,
                      x, y, m, 0 if one_plane else V, thr, long, long.numel(),
                      block)
        colsort2_spmv.launches += 1
        colsort2_hub(col, val, hub, x, y, block)
    return y


colsort2_spmv.launches = 0


def colsort2_spmm(indptr, col, val, hub, x, shape, K, V, thr,
                  block=_build.DEFAULT_BLOCK):
    """Y = A @ X through the plan for a dense row-major block X (n, k): the
    plain version on CPU tensors; on CUDA tensors the SpMM main kernel (a
    team of lanes a main row, spmm_schedule's C columns a lane) and, where
    the plan has hub rows, the SpMM hub pair.  Every row of Y is written."""
    m = shape[0]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return colsort2_spmv_plain(indptr, col, val, hub, x, m, K, V, thr)
    _check(indptr, col, val, hub, x, shape, 2)
    k = x.shape[1]
    y = torch.empty((m, k), dtype=x.dtype, device=x.device)
    if m:
        width, cols, _, team_shift = spmm_schedule(k, alignment(x, y),
                                                   x.element_size())
        _build.launch("cusp_colsort2_spmm", val.dtype, x.device, indptr, col, val,
                      x, y, m, k, V, thr, width, cols, team_shift, block)
        colsort2_spmm.launches += 1
        colsort2_hub(col, val, hub, x, y, block)
    return y


colsort2_spmm.launches = 0


def hub_tensors(hub, device):
    return tuple(torch.from_numpy(a).to(device) for a in hub)


def build_colsort2(A, config):
    """Plan A for the colsort2 kernels: its CSR form (other formats converted
    on the host), `vrow_planes` planes (default 2) of `vrow_len` entries
    (default ceil(hub_cap / K)), rows above min(hub_cap, K V) in the hub
    region (hub_cap 0: max(64, 4 nnz / m), the JAX default), values in the
    storage dtype that `value_dtype` names, `block_size` threads per block.
    The JAX builder's TPU layout keys (block_entries, col_window, vrow_span,
    lane_cap, pack16, mix_chunks, scatter_dot, stream_x, spmm_kb) are
    ignored.  An empty matrix raises FormatConversionException (the default
    path serves it)."""
    if A.dtype.is_complex:
        raise NotImplementedException("colsort2 kernel supports real dtypes only")
    K = int(config.get("vrow_planes") or K_DEFAULT)
    V = int(config.get("vrow_len") or 0)
    if not 1 <= K <= 8 or V < 0:
        raise NotImplementedException("vrow_planes must be 1 to 8, vrow_len >= 0")
    block = _build.block_size(config)
    if A.format != "csr":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        A = convert(A, "csr")
    if A.nnz == 0:
        raise FormatConversionException("empty matrix — use the default path")
    indptr = host_array(A.indptr)
    thr, V, hub = plan_colsort2(indptr, K, V, int(config.get("hub_cap") or 0))
    long = long_rows(indptr, thr)
    lengths = np.diff(np.asarray(indptr, dtype=np.int64))
    one_plane = int(lengths[lengths <= thr].max(initial=0)) <= V
    nnz = A.nnz
    arrays = {"indptr": A.indptr, "col": A.col[:nnz].contiguous(),
              "val": A.val[:nnz].to(plan_value_dtype(config, A.dtype)).contiguous(),
              "hub": hub_tensors(hub, A.device),
              "long": torch.from_numpy(long).to(A.device)}
    shape = A.shape

    def apply(arrays, x):
        return colsort2_spmv(arrays["indptr"], arrays["col"], arrays["val"],
                             arrays["hub"], arrays["long"], x, shape, K, V, thr,
                             block, one_plane)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    fn.plan_stats = {"impl": "colsort2", "vrow_planes": K, "vrow_len": V,
                     "thr": thr, "hub_rows": int(hub[0].size),
                     "hub_vrows": int(hub[2].size), "long_rows": int(long.size)}
    return fn
