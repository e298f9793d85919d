"""CSR SpMV: the CUDA kernel's wrapper, its plain PyTorch version, and the
plan builder.

Replaces the JAX package's Pallas one-hot kernel, `_onehot_kernel`
(cusp_autotuned_tpu/kernels/pallas_csr.py:171), with an nnz-balanced tile
kernel, `csrc/csr_spmv.cu` (the fork's `csr_kernel_balanced`): the entries
are cut into tiles of `block * ENTRIES_PER_THREAD`, the plan holds the row
that starts each tile (`tile_row`, one searchsorted over indptr at build
time) and two carry slots a tile for the rows that tile boundaries cut, and
a second small kernel folds the carries in tile order.  A tile whose rows
outnumber its entries (a run of empty rows) is walked by several blocks,
each over at most a tile's count of its rows (`tile_splits`).  No atomics.
The one-hot gather and scatter, the column windows and the VMEM cap of the
TPU kernel have no counterpart here; see the source for why.  COO matrices
reach the kernel through a host conversion to CSR when the plan is built,
and so do ELL, ELLR and HYB (the JAX package plans every format for its
one-hot kernel from the matrix's COO view, kernels/pallas_spmv.py:24-27).
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.dia import _scale, promoted
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)


def csr_spmv_plain(row, col, val, x, num_rows):
    """y[row[e]] += val[e] * x[col[e]] by a gather and an index_add_,
    accumulated in the promoted type of val and x.  Padding entries carry
    row == num_rows and fall into a slot that is dropped.  x may be (n,) or
    (n, k)."""
    x = promoted(val, x)
    prod = _scale(val.to(x.dtype), torch.index_select(x, 0, col))
    y = x.new_zeros((num_rows + 1,) + x.shape[1:])
    y.index_add_(0, row, prod)
    return y[:num_rows]


# entries a thread loads into its tile, kPerThread in csrc/csr_spmv.cu: a
# tile holds block * 4 entries (1024 at the default block of 256)
ENTRIES_PER_THREAD = 4


def tile_rows(indptr, nnz, tile):
    """tile_row[t] for t = 0 .. tiles: the row that holds entry t * tile
    (the last row whose start is at most t * tile; m past the last entry),
    tiles = ceil(nnz / tile), at least 1.  One searchsorted on indptr's
    device."""
    tiles = max(1, -(-nnz // tile))
    starts = torch.arange(tiles + 1, dtype=torch.int64, device=indptr.device) * tile
    starts = starts.clamp_(max=nnz).to(indptr.dtype)
    return (torch.searchsorted(indptr, starts, right=True) - 1).to(torch.int32)


def tile_splits(tile_row, m, rows):
    """(split_tile, split_row): the blocks that the tile kernel adds after
    its block a tile, each with its tile and first row.  Tile t walks rows
    tile_row[t] (0 for t = 0) to min(tile_row[t + 1], m - 1) in parts of
    `rows` rows: block t takes the first part, and each later part is a
    split.  On tile_row's device; one host sync for the count."""
    r_lo = tile_row[:-1].to(torch.int64)
    r_lo[0] = 0
    r_hi = tile_row[1:].to(torch.int64).clamp(max=m - 1)
    more = (r_hi - r_lo).clamp(min=0) // rows
    split_tile = torch.repeat_interleave(
        torch.arange(more.shape[0], device=tile_row.device), more)
    j = 1 + torch.arange(split_tile.shape[0], device=tile_row.device) \
        - (torch.cumsum(more, 0) - more)[split_tile]
    split_row = r_lo[split_tile] + j * rows
    return split_tile.to(torch.int32), split_row.to(torch.int32)


def csr_spmv(a, x, shape, block=_build.DEFAULT_BLOCK):
    """y = A @ x through build_csr's plan `a` (indptr, row, col, val,
    tile_row, split_tile, split_row, carry_row, carry_val).  On CPU tensors
    this is the plain version (which reads the expanded `row`); on CUDA
    tensors it launches the tile kernel and the carry fold (which read
    `indptr` and the plan's tiles of block * ENTRIES_PER_THREAD entries),
    and raises on what the kernels do not take."""
    if x.dim() != 1:
        raise NotImplementedException("the CSR kernel takes 1-D x only")
    m, n = shape
    indptr, col, val = a["indptr"], a["col"], a["val"]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return csr_spmv_plain(a["row"], col, val, x, m)
    tile_row, carry_row, carry_val = a["tile_row"], a["carry_row"], a["carry_val"]
    split_tile, split_row = a["split_tile"], a["split_row"]
    dev = x.device
    if dev.type != "cuda" or not (indptr.device == col.device == val.device
                                  == tile_row.device == split_tile.device
                                  == split_row.device == carry_row.device
                                  == carry_val.device == dev):
        raise InvalidInputException(
            f"CSR kernel needs its plan and x on one CUDA device (got "
            f"{indptr.device}, {col.device}, {val.device}, {tile_row.device}, "
            f"{x.device})")
    store = _build.STORAGE.get(val.dtype)
    if store is None or x.dtype != store[1] or carry_val.dtype != store[1]:
        raise InvalidInputException(
            f"CSR kernel takes f32/bf16 values with f32 x, or f64 with f64 "
            f"(got {val.dtype} values, {x.dtype} x)")
    if indptr.dtype != torch.int32 or col.dtype != torch.int32 \
            or tile_row.dtype != torch.int32 or carry_row.dtype != torch.int32 \
            or split_tile.dtype != torch.int32 or split_row.dtype != torch.int32:
        raise InvalidInputException("indptr, col and the plan's rows must be int32")
    nnz = col.shape[0]
    tiles = tile_row.shape[0] - 1
    tile = block * ENTRIES_PER_THREAD
    if indptr.shape != (m + 1,) or x.shape != (n,) or col.shape != val.shape \
            or tiles != max(1, -(-nnz // tile)) \
            or carry_row.shape != (2 * tiles,) or carry_val.shape != (2 * tiles,) \
            or split_tile.shape != split_row.shape or split_tile.dim() != 1:
        raise InvalidInputException(
            f"shape mismatch: indptr {tuple(indptr.shape)}, col "
            f"{tuple(col.shape)}, val {tuple(val.shape)}, x {tuple(x.shape)}, "
            f"{tiles} tiles for tiles of {tile}, matrix {shape}")
    if not (indptr.is_contiguous() and col.is_contiguous() and val.is_contiguous()
            and x.is_contiguous() and tile_row.is_contiguous()
            and split_tile.is_contiguous() and split_row.is_contiguous()):
        raise InvalidInputException("CSR kernel needs contiguous tensors")
    y = torch.empty(m, dtype=x.dtype, device=dev)
    if m:
        _build.launch("cusp_csr_spmv", val.dtype, dev, indptr, col, val, x, y, m,
                      nnz, tile_row, split_tile, split_row, split_tile.shape[0],
                      carry_row, carry_val, block)
        csr_spmv.launches += 1
    return y


csr_spmv.launches = 0


def build_csr(A, config):
    """Plan A for the kernel: CSR as it is; any other format through its
    entries (ELL's -1 slots dropped) converted to CSR on the host.  Values
    are in the storage dtype that `value_dtype` names, and the launch has
    `block_size` threads per block, so tiles of block_size *
    ENTRIES_PER_THREAD entries: `tile_row`, the blocks that walk each
    tile's rows (`tile_splits`, at most a tile's count of rows each) and the
    carry slots are planned here, on A's device, once.  Complex values raise
    NotImplementedException here, at build time."""
    if A.dtype.is_complex:
        raise NotImplementedException("CSR kernel supports real dtypes only")
    if A.format != "csr":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        A = convert(A, "csr")
    store = plan_value_dtype(config, A.dtype)
    block = _build.block_size(config)
    tile = block * ENTRIES_PER_THREAD
    nnz = A.nnz
    col, val = A.col[:nnz].contiguous(), A.val[:nnz].to(store).contiguous()
    tile_row = tile_rows(A.indptr, nnz, tile)
    tiles = tile_row.shape[0] - 1
    split_tile, split_row = tile_splits(tile_row, A.num_rows, tile)
    arrays = {"indptr": A.indptr, "row": A.row[:nnz], "col": col, "val": val,
              "tile_row": tile_row, "split_tile": split_tile,
              "split_row": split_row,
              "carry_row": torch.empty(2 * tiles, dtype=torch.int32, device=A.device),
              "carry_val": torch.empty(2 * tiles, dtype=_build.accumulation(store),
                                       device=A.device)}
    shape = A.shape

    def apply(arrays, x):
        return csr_spmv(arrays, x, shape, block)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    fn.plan_stats = {"impl": "cuda", "tile": tile, "tiles": tiles,
                     "blocks": tiles + split_tile.shape[0]}
    return fn
