"""nnz-balanced COO SpMV: the CUDA kernel's wrapper, its plain PyTorch
version, and the planner (the port's `colsort` impl).

Replaces the JAX package's column-lane-binned Pallas kernels at their SpMV
sites, `_main_kernel` (cusp_autotuned_tpu/kernels/pallas_colsort.py:162),
`_hub_kernel` (:274), `_main_streamed_kernel` (:558) and
`_hub_streamed_kernel` (:615), with one kernel, `csrc/coo_spmv.cu`, in the
style of the fork's `coo_warp_reduce`: the row-sorted entry stream is cut
into chunks of 32 * `values_per_thread` entries, one per warp, summed by a
segmented warp scan; rows cut by a chunk boundary leave as carries that a
second small kernel folds into y in order.  Long rows are long segments,
so there is no separate hub pass.  The SpMM sites, `_main_spmm_kernel`
(:885) and `_hub_spmm_kernel` (:932) from :426, :500, :751 and :831, become
`csrc/coo_spmm.cu`: the same chunks with lanes over a column tile and a
carry per chunk end per column, folded in order.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array
from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

VALUES_PER_THREAD = 4              # default: chunks of 128 entries


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


def coo_spmv(row, col, val, x, shape, vpt=VALUES_PER_THREAD,
             block=_build.DEFAULT_BLOCK):
    """y = A @ x for row-sorted entries (row, col, val) with no padding.  On
    CPU tensors this is the plain version; on CUDA tensors it launches the
    chunk kernel and the carry fold with `vpt` entries per lane per chunk (a
    2-D x goes to coo_spmm), and raises on what the kernels do not take."""
    if x.dim() == 2:
        return coo_spmm(row, col, val, x, shape, vpt, block)
    if x.dim() != 1:
        raise NotImplementedException(
            "the COO kernels take x of shape (n,) or (n, k)")
    m = shape[0]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return coo_spmv_plain(row, col, val, x, m)
    _check(row, col, val, x, shape, 1)
    nnz = row.shape[0]
    y = torch.zeros(m, dtype=x.dtype, device=x.device)
    if nnz:
        chunks = -(-nnz // (32 * vpt))
        carry_row = torch.empty(2 * chunks, dtype=torch.int32, device=x.device)
        carry_val = torch.empty(2 * chunks, dtype=x.dtype, device=x.device)
        _build.launch("cusp_coo_spmv", val.dtype, x.device, row, col, val, nnz,
                      x, y, carry_row, carry_val, vpt, block)
        coo_spmv.launches += 1
    return y


coo_spmv.launches = 0


def coo_spmm(row, col, val, x, shape, vpt=VALUES_PER_THREAD,
             block=_build.DEFAULT_BLOCK):
    """Y = A @ X for row-sorted entries and a dense row-major block X (n, k):
    the plain version on CPU tensors; on CUDA tensors the chunk kernel with
    lanes over a column tile and the carry fold, a carry per chunk end per
    column (one launch of the wrapper, two kernels)."""
    m = shape[0]
    if x.device.type == "cpu" and val.device.type == "cpu":
        return coo_spmv_plain(row, col, val, x, m)
    _check(row, col, val, x, shape, 2)
    nnz, k = row.shape[0], x.shape[1]
    y = torch.zeros((m, k), dtype=x.dtype, device=x.device)
    if nnz:
        chunks = -(-nnz // (32 * vpt))
        carry_row = torch.empty(2 * chunks, dtype=torch.int32, device=x.device)
        carry_val = torch.empty((2 * chunks, k), dtype=x.dtype, device=x.device)
        _build.launch("cusp_coo_spmm", val.dtype, x.device, row, col, val, nnz,
                      x, y, k, carry_row, carry_val, vpt, block)
        coo_spmm.launches += 1
    return y


coo_spmm.launches = 0


def build_colsort(A, config):
    """Plan A for the COO kernel: its stored entries sorted by row and cut
    to nnz (CSR's expanded rows as they are, a row-sorted COO as it is,
    anything else through a host conversion to CSR), values in the storage
    dtype that `value_dtype` names, `values_per_thread` entries per lane per
    chunk and `block_size` threads per block.  An empty matrix raises
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
    arrays = {"row": A.row[:nnz].contiguous(), "col": A.col[:nnz].contiguous(),
              "val": A.val[:nnz].to(plan_value_dtype(config, A.dtype)).contiguous()}
    shape = A.shape

    def apply(arrays, x):
        return coo_spmv(arrays["row"], arrays["col"], arrays["val"], x, shape,
                        vpt, block)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    return fn
