"""nnz-balanced COO SpMV: the CUDA kernel's wrapper, its plain PyTorch
version, and the planner (the port's `colsort` impl).

Replaces the JAX package's column-lane-binned Pallas kernels at their SpMV
sites, `_main_kernel` (cusp_autotuned_tpu/kernels/pallas_colsort.py:162),
`_hub_kernel` (:274), `_main_streamed_kernel` (:558) and
`_hub_streamed_kernel` (:615), with one kernel, `csrc/coo_spmv.cu`, in the
style of the fork's COO family and of merge-path: the row-sorted entry
stream is cut into chunks of 32 * `values_per_thread` entries, one per
warp; each lane adds up its `values_per_thread` consecutive entries in
registers and one segmented warp scan a chunk joins the rows that cross
lanes; rows cut by a chunk boundary leave as carries (planned once with
the plan) that a second small kernel folds into y in order.  The kernel
writes every row of y, empty rows as 0, so y needs no zero fill, except
for a matrix with a run of more than `GAP_ROWS` empty rows: one lane
writes a run, so the plan of such a matrix zero-fills y first.  Long
rows are long segments, so there is no separate hub pass.  The SpMM
sites, `_main_spmm_kernel` (:885) and `_hub_spmm_kernel` (:932) from
:426, :500, :751 and :831, become
`csrc/coo_spmm.cu`: the same chunks, each warp's split among teams of
lanes that take C columns of X with 16-byte loads (the DIA SpMM's
schedule, kernels/dia.py spmm_schedule), a carry per chunk end per column,
folded in order; it writes every row of Y as the SpMV writes y.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
from cusp_autotuned_tpu_torch.kernels.dia import alignment, spmm_schedule
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

VALUES_PER_THREAD = 4              # default: chunks of 128 entries
# the longest run of empty rows the chunk kernel writes itself (kGapRows in
# csrc/coo_spmv.cu); a plan with a longer run zero-fills y before the launch
GAP_ROWS = 32


def coo_spmv_plain(row, col, val, x, num_rows):
    """y[row[e]] += val[e] * x[col[e]] by a gather and an index_add_,
    accumulated in x's dtype; x may be (n,) or (n, k)."""
    return csr_spmv_plain(row, col, val, x, num_rows)


def _check(row, col, val, x, shape, rank):
    """Raise on what the kernels do not take."""
    n = shape[1]
    if not (row.device == col.device == val.device == x.device) \
            or x.device.type != "cuda":
        raise InvalidInputException(
            f"COO kernel needs row, col, val and x on one CUDA device (got "
            f"{row.device}, {col.device}, {val.device}, {x.device})")
    if val.dtype not in _build.STORAGE or x.dtype != _build.STORAGE[val.dtype][1]:
        raise InvalidInputException(
            f"COO kernel takes f32/bf16 values with f32 x, or f64 with f64 "
            f"(got {val.dtype} values, {x.dtype} x)")
    if row.dtype != torch.int32 or col.dtype != torch.int32:
        raise InvalidInputException("row and col must be int32")
    if not (row.shape == col.shape == val.shape) or x.dim() != rank \
            or x.shape[0] != n or (rank == 2 and x.shape[1] < 1):
        raise InvalidInputException(
            f"shape mismatch: row {tuple(row.shape)}, col {tuple(col.shape)}, "
            f"val {tuple(val.shape)}, x {tuple(x.shape)}, matrix {shape}")
    if not all(t.is_contiguous() for t in (row, col, val, x)):
        raise InvalidInputException("COO kernel needs contiguous tensors")


def coo_spmv(a, x, shape, vpt=VALUES_PER_THREAD, block=_build.DEFAULT_BLOCK,
             zero_fill=False):
    """y = A @ x through build_colsort's plan `a`: row-sorted entries (row,
    col, val) with no padding, and the carry slots (carry_row, carry_val) of
    its chunks of 32 * `vpt` entries.  On CPU tensors this is the plain
    version; on CUDA tensors it launches the chunk kernel and the carry fold
    (a 2-D x goes to coo_spmm), and raises on what the kernels do not
    take.  `zero_fill` (the plan's, set where a run of more than GAP_ROWS
    rows holds no entry) zero-fills y before the launch."""
    row, col, val = a["row"], a["col"], a["val"]
    if x.dim() == 2:
        return coo_spmm(a, x, shape, vpt, block, zero_fill)
    if x.dim() != 1:
        raise NotImplementedException(
            "the COO kernels take x of shape (n,) or (n, k)")
    m = shape[0]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return coo_spmv_plain(row, col, val, x, m)
    _check(row, col, val, x, shape, 1)
    nnz = row.shape[0]
    carry_row, carry_val = a["carry_row"], a["carry_val"]
    chunks = -(-nnz // (32 * vpt))
    if carry_row.shape != (2 * chunks,) or carry_val.shape != (2 * chunks,) \
            or carry_row.dtype != torch.int32 or carry_val.dtype != x.dtype \
            or carry_row.device != x.device or carry_val.device != x.device:
        raise InvalidInputException(
            f"the plan's carries ({tuple(carry_row.shape)} {carry_row.dtype}, "
            f"{tuple(carry_val.shape)} {carry_val.dtype}) are not 2 x {chunks} "
            f"chunks of {32 * vpt} entries for x of {x.dtype} on {x.device}")
    if not (nnz and m):
        return torch.zeros(m, dtype=x.dtype, device=x.device)
    y = (torch.zeros if zero_fill else torch.empty)(m, dtype=x.dtype,
                                                    device=x.device)
    _build.launch("cusp_coo_spmv", val.dtype, x.device, row, col, val, nnz, x, y,
                  m, carry_row, carry_val, vpt, block)
    coo_spmv.launches += 1
    return y


coo_spmv.launches = 0


def coo_spmm(a, x, shape, vpt=VALUES_PER_THREAD, block=_build.DEFAULT_BLOCK,
             zero_fill=False):
    """Y = A @ X through build_colsort's plan `a` and a dense row-major block
    X (n, k): the plain version on CPU tensors; on CUDA tensors the chunk
    kernel, a chunk a warp and its teams over C columns, and the carry fold
    (one launch of the wrapper, two kernels), with the plan's carry_row and
    a carry per chunk end per column.  The kernels write every row of Y;
    `zero_fill` (the plan's) zero-fills Y first."""
    row, col, val = a["row"], a["col"], a["val"]
    m = shape[0]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return coo_spmv_plain(row, col, val, x, m)
    _check(row, col, val, x, shape, 2)
    nnz, k = row.shape[0], x.shape[1]
    carry_row = a["carry_row"]
    chunks = -(-nnz // (32 * vpt))
    if carry_row.shape != (2 * chunks,) or carry_row.dtype != torch.int32 \
            or carry_row.device != x.device:
        raise InvalidInputException(
            f"the plan's carry rows ({tuple(carry_row.shape)} {carry_row.dtype}) "
            f"are not 2 x {chunks} chunks of {32 * vpt} entries on {x.device}")
    if not (nnz and m):
        return torch.zeros((m, k), dtype=x.dtype, device=x.device)
    y = (torch.zeros if zero_fill else torch.empty)((m, k), dtype=x.dtype,
                                                    device=x.device)
    carry_val = torch.empty((2 * chunks, k), dtype=x.dtype, device=x.device)
    width, cols, _, team_shift = spmm_schedule(k, alignment(x, y), x.element_size())
    _build.launch("cusp_coo_spmm", val.dtype, x.device, row, col, val, nnz, x, y,
                  m, k, carry_row, carry_val, vpt, width, cols, team_shift, block)
    coo_spmm.launches += 1
    return y


coo_spmm.launches = 0


def build_colsort(A, config):
    """Plan A for the COO kernel: its stored entries sorted by row and cut
    to nnz (CSR's expanded rows as they are, a row-sorted COO as it is,
    anything else through a host conversion to CSR), values in the storage
    dtype that `value_dtype` names, `values_per_thread` entries per lane per
    chunk and `block_size` threads per block, and the chunks' carry slots
    (two a chunk, in the accumulation dtype), planned here once so that a
    call allocates nothing but y, and whether y is zero-filled (a run of
    more than GAP_ROWS empty rows).  An empty matrix raises
    FormatConversionException (the default path serves it)."""
    if A.dtype.is_complex:
        raise NotImplementedException("COO kernel supports real dtypes only")
    vpt = int(config.get("values_per_thread") or VALUES_PER_THREAD)
    if not 1 <= vpt <= 64:
        raise NotImplementedException("values_per_thread must be 1 to 64")
    block = _build.block_size(config)
    if A.format == "coo" and np.any(np.diff(host_array(A.row[:A.nnz])) < 0):
        from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
        row, col, val = (host_array(t[:A.nnz]) for t in (A.row, A.col, A.val))
        A = coo_matrix(row, col, val, A.shape, device=A.device)   # sorts
    elif A.format not in ("csr", "coo"):
        from cusp_autotuned_tpu_torch.ops.convert import convert
        A = convert(A, "csr")
    if A.nnz == 0:
        raise FormatConversionException("empty matrix — use the default path")
    nnz = A.nnz
    store = plan_value_dtype(config, A.dtype)
    chunks = -(-nnz // (32 * vpt))
    arrays = {"row": A.row[:nnz].contiguous(), "col": A.col[:nnz].contiguous(),
              "val": A.val[:nnz].to(store).contiguous(),
              "carry_row": torch.empty(2 * chunks, dtype=torch.int32, device=A.device),
              "carry_val": torch.empty(2 * chunks, dtype=_build.accumulation(store),
                                       device=A.device)}
    shape = A.shape
    zero_fill = longest_gap(arrays["row"], shape[0]) > GAP_ROWS

    def apply(arrays, x):
        return coo_spmv(arrays, x, shape, vpt, block, zero_fill)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    fn.plan_stats = {"impl": "colsort", "zero_fill": zero_fill}
    return fn


def longest_gap(row, m):
    """The longest run of rows that hold no entry, for row-sorted row
    indices of an m-row matrix (the rows before the first entry and after
    the last included).  One reduction on row's device."""
    edges = torch.cat([row.new_tensor([-1]), row, row.new_tensor([m])])
    return int((edges[1:] - edges[:-1]).max()) - 1
