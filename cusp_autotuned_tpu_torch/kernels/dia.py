"""DIA SpMV and SpMM: the CUDA kernels' wrappers, their plain PyTorch
version, and the plan builder.

Replaces the JAX package's Pallas DIA kernels, `_dia_kernel`
(cusp_autotuned_tpu/kernels/pallas_dia.py:393) and `_dia_streamed_kernel`
(:240), with one CUDA kernel, `csrc/dia_spmv.cu`, and its SpMM kernel
`_dia_spmm_kernel` (:381, with the XLA path for k <= 64, :271) with one
kernel for every k, `csrc/dia_spmm.cu`.  Both are bound by bytes: ndiag·rows
of diagonal data in the storage type, plus x read and y written once; see
the sources for their design.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)


def _scale(vals, xs):
    """vals (E,) times xs (E,) or (E, k)."""
    return vals * xs if xs.dim() == 1 else vals[:, None] * xs


def _pad_rows(x, left, right):
    z = x.new_zeros
    return torch.cat([z((left,) + x.shape[1:]), x, z((right,) + x.shape[1:])])


def dia_spmv_plain(data, offsets, x, shape):
    """y = A @ x by shifted slices of a zero-padded x, one per diagonal,
    accumulated in x's dtype (the XLA path of the JAX package's
    ops/multiply.py:spmv_dia).  x may be (n,) or (n, k): this is the plain
    version of both kernels."""
    m, n = shape
    mp = data.shape[1]
    left = -min(0, min(offsets))
    x_pad = _pad_rows(x, left, max(n, mp + max(offsets)) - n)
    acc = None
    for d, off in enumerate(offsets):
        seg = x_pad[left + off: left + off + mp]
        term = _scale(data[d].to(x.dtype), seg)
        acc = term if acc is None else acc + term
    return acc[:m]


def _check(data, offsets, x, shape, rank):
    """Raise on what the kernels do not take."""
    m, n = shape
    nd, pitch = data.shape
    if not (data.device == offsets.device == x.device) or x.device.type != "cuda":
        raise InvalidInputException(
            f"DIA kernel needs data, offsets and x on one CUDA device "
            f"(got {data.device}, {offsets.device}, {x.device})")
    if data.dtype not in _build.STORAGE or x.dtype != _build.STORAGE[data.dtype][1]:
        raise InvalidInputException(
            f"DIA kernel takes f32/bf16 data with f32 x, or f64 with f64 "
            f"(got {data.dtype} data, {x.dtype} x)")
    if offsets.dtype != torch.int32 or offsets.shape != (nd,):
        raise InvalidInputException("offsets must be int32 of shape (ndiag,)")
    if x.dim() != rank or x.shape[0] != n or (rank == 2 and x.shape[1] < 1) \
            or pitch < m:
        raise InvalidInputException(
            f"shape mismatch: data {tuple(data.shape)}, x {tuple(x.shape)}, "
            f"matrix {shape}")
    if not (data.is_contiguous() and offsets.is_contiguous() and x.is_contiguous()):
        raise InvalidInputException("DIA kernel needs contiguous tensors")


def dia_spmv(data, offsets, x, shape, block=_build.DEFAULT_BLOCK):
    """y = A @ x for a DIA matrix with diagonals `data` (ndiag, pitch) and
    int32 `offsets` (ndiag,).  On CPU tensors this is the plain version; on
    CUDA tensors it launches the kernel with `block` threads per block (a
    2-D x goes to dia_spmm), and raises on what the kernel does not take."""
    if x.dim() == 2:
        return dia_spmm(data, offsets, x, shape, block)
    if x.dim() != 1:
        raise NotImplementedException("the DIA kernels take x of shape (n,) or (n, k)")
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmv_plain(data, tuple(offsets.tolist()), x, shape)
    _check(data, offsets, x, shape, 1)
    m, n = shape
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        _build.launch("cusp_dia_spmv", data.dtype, x.device,
                      data, offsets, data.shape[0], data.shape[1], x, y, m, n,
                      block)
        dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def dia_spmm(data, offsets, x, shape, block=_build.DEFAULT_BLOCK):
    """Y = A @ X for a dense row-major block X (n, k): the plain version on
    CPU tensors, the SpMM kernel on CUDA tensors."""
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmv_plain(data, tuple(offsets.tolist()), x, shape)
    _check(data, offsets, x, shape, 2)
    m, n = shape
    k = x.shape[1]
    y = torch.empty((m, k), dtype=x.dtype, device=x.device)
    if m:
        _build.launch("cusp_dia_spmm", data.dtype, x.device,
                      data, offsets, data.shape[0], data.shape[1], x, y, m, n,
                      k, block)
        dia_spmm.launches += 1
    return y


dia_spmm.launches = 0


def build_dia(A, config):
    """Plan A (a DIA container) for the kernel: diagonal data in the storage
    dtype that `value_dtype` names, offsets as a device tensor, launched
    with `block_size` threads per block."""
    store = plan_value_dtype(config, A.dtype)
    block = _build.block_size(config)
    arrays = {
        "data": A.data.to(store).contiguous(),
        "offsets": torch.tensor(A.offsets, dtype=torch.int32, device=A.device),
    }
    shape = A.shape

    def apply(arrays, x):
        return dia_spmv(arrays["data"], arrays["offsets"], x, shape, block)

    def fn(x):
        return apply(arrays, x)

    fn.planned_arrays = arrays
    fn.apply = apply
    return fn
