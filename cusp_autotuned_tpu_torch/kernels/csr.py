"""CSR SpMV: the CUDA kernel's wrapper, its plain PyTorch version, and the
plan builder.

Replaces the JAX package's Pallas one-hot kernel, `_onehot_kernel`
(cusp_autotuned_tpu/kernels/pallas_csr.py:171), with a CSR-vector kernel,
`csrc/csr_spmv.cu`: one warp per row, no atomics.  The one-hot gather and
scatter, the block and window planning and the VMEM cap of the TPU kernel
have no counterpart here; see the source for why.  COO matrices reach the
kernel through a host conversion to CSR when the plan is built, and so do
ELL, ELLR and HYB (the JAX package plans every format for its one-hot
kernel from the matrix's COO view, kernels/pallas_spmv.py:24-27).
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


def csr_spmv(indptr, row, col, val, x, shape, block=_build.DEFAULT_BLOCK):
    """y = A @ x for a CSR matrix.  On CPU tensors this is the plain version
    (which reads the expanded `row`); on CUDA tensors it launches the kernel
    (which reads `indptr`) with `block` threads per block, and raises on
    what the kernel does not take."""
    if x.dim() != 1:
        raise NotImplementedException("the CSR kernel takes 1-D x only")
    m, n = shape
    if x.device.type == "cpu" and val.device.type == "cpu":
        return csr_spmv_plain(row, col, val, x, m)
    if not (indptr.device == col.device == val.device == x.device) \
            or x.device.type != "cuda":
        raise InvalidInputException(
            f"CSR kernel needs indptr, col, val and x on one CUDA device "
            f"(got {indptr.device}, {col.device}, {val.device}, {x.device})")
    if val.dtype not in _build.STORAGE or x.dtype != _build.STORAGE[val.dtype][1]:
        raise InvalidInputException(
            f"CSR kernel takes f32/bf16 values with f32 x, or f64 with f64 "
            f"(got {val.dtype} values, {x.dtype} x)")
    if indptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise InvalidInputException("indptr and col must be int32")
    if indptr.shape != (m + 1,) or x.shape != (n,) or col.shape != val.shape:
        raise InvalidInputException(
            f"shape mismatch: indptr {tuple(indptr.shape)}, col "
            f"{tuple(col.shape)}, val {tuple(val.shape)}, x {tuple(x.shape)}, "
            f"matrix {shape}")
    if not (indptr.is_contiguous() and col.is_contiguous()
            and val.is_contiguous() and x.is_contiguous()):
        raise InvalidInputException("CSR kernel needs contiguous tensors")
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        _build.launch("cusp_csr_spmv", val.dtype, x.device,
                      indptr, col, val, x, y, m, block)
        csr_spmv.launches += 1
    return y


csr_spmv.launches = 0


def build_csr(A, config):
    """Plan A for the kernel: CSR as it is; any other format through its
    entries (ELL's -1 slots dropped) converted to CSR on the host.  Values
    are in the storage dtype that `value_dtype` names, and the launch has
    `block_size` threads per block.  Complex values raise
    NotImplementedException here, at build time."""
    if A.dtype.is_complex:
        raise NotImplementedException("CSR kernel supports real dtypes only")
    if A.format != "csr":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        A = convert(A, "csr")
    store = plan_value_dtype(config, A.dtype)
    block = _build.block_size(config)
    arrays = {"indptr": A.indptr, "row": A.row, "col": A.col,
              "val": A.val.to(store).contiguous()}
    shape = A.shape

    def apply(arrays, x):
        return csr_spmv(arrays["indptr"], arrays["row"], arrays["col"],
                        arrays["val"], x, shape, block)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    return fn
