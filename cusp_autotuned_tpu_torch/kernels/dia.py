"""DIA SpMV and SpMM: the CUDA kernels' wrappers, their plain PyTorch
version, and the plan builder; and the same two products on one row band
of the matrix against a replicated, padded x, the kernels of the banded
via_dia plan (parallel/sharded_plans.py).

Replaces the JAX package's Pallas DIA kernels, `_dia_kernel`
(cusp_autotuned_tpu/kernels/pallas_dia.py:393) and `_dia_streamed_kernel`
(:240), with one CUDA kernel, `csrc/dia_spmv.cu`, and its SpMM kernel
`_dia_spmm_kernel` (:381, with the XLA path for k <= 64, :271) with one
kernel for every k, `csrc/dia_spmm.cu`.  The banded plan's `_dia_kernel`
(cusp_autotuned_tpu/parallel/sharded_plans.py:154) becomes the band entry
points of the same two sources.  All are bound by bytes: ndiag·rows of
diagonal data in the storage type, plus x read and y written once; see the
sources for their design.  `spmm_schedule` picks the SpMM kernels'
columns and rows a lane and their load width from k and the blocks'
alignment (csrc/dia_spmm_body.cuh).
"""

from __future__ import annotations

import functools

import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)


def _scale(vals, xs):
    """vals (E,) times xs (E,) or (E, k)."""
    return vals * xs if xs.dim() == 1 else vals[:, None] * xs


def promoted(vals, x):
    """x in the type of its product with `vals`, torch.promote_types of the
    two: a complex matrix times a real x is complex, an f64 matrix times an
    f32 x is f64, and bf16 storage times an f32 x stays f32."""
    return x.to(torch.promote_types(vals.dtype, x.dtype))


def _pad_rows(x, left, right):
    z = x.new_zeros
    return torch.cat([z((left,) + x.shape[1:]), x, z((right,) + x.shape[1:])])


def dia_spmv_plain(data, offsets, x, shape):
    """y = A @ x by shifted slices of a zero-padded x, one per diagonal,
    accumulated in the promoted type of data and x (the XLA path of the JAX
    package's ops/multiply.py:spmv_dia).  x may be (n,) or (n, k): this is
    the plain version of both kernels."""
    x = promoted(data, x)
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


# a lane of the SpMM kernels takes whole rows of k <= NARROW columns, and
# keeps R consecutive rows: ROWS_NARROW at such k, ROWS_WIDE past it
# (kRowsNarrow and kRowsWide in csrc/dia_spmm.cu).  The probe's rows=R
# modes chose them on poisson5pt 1000x1000: at k = 3, R = 4 took 1.8x R =
# 2's time (R = 1 tied); R = 4 tied R = 2 at k = 16 and beat it by 7.5 % at
# k = 128 (PERF.md §6, row 15)
NARROW = 4
ROWS_NARROW, ROWS_WIDE = 2, 4


@functools.lru_cache(maxsize=None)
def spmm_schedule(k, align, itemsize, rows=None):
    """(width, cols, rows, team_shift) of the DIA SpMM kernels for k columns
    of X and Y in an accumulation type of `itemsize` bytes, `align` the
    largest power of two (at most 16) that divides the addresses of both:
    a lane takes `cols` consecutive columns of `rows` consecutive rows
    (`rows` given overrides the shipped R) and moves `width` values at a
    load or store, a team of 1 << team_shift lanes a tile of columns.
    Where k <= NARROW a lane takes whole rows; past it, 16-byte loads where
    k and the alignment allow them, else 8-byte, else one value."""
    def fits(w):           # one value always: a tensor is aligned to its type
        return w == 1 or (k % w == 0 and align % (w * itemsize) == 0)
    width = next(w for w in (4, 2, 1) if w * itemsize <= 16 and fits(w))
    narrow = k <= NARROW
    cols = k if narrow else width
    if rows is None:
        rows = ROWS_NARROW if narrow else ROWS_WIDE
    lanes = -(-k // cols)
    return width, cols, rows, min(5, (lanes - 1).bit_length())


def alignment(*tensors):
    """The largest power of two, at most 16, that divides every tensor's
    address."""
    bits = 16
    for t in tensors:
        bits = min(bits, (t.data_ptr() & -t.data_ptr()) or 16)
    return bits


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
                      k, *spmm_schedule(k, alignment(x, y), x.element_size()),
                      block)
        dia_spmm.launches += 1
    return y


dia_spmm.launches = 0


def dia_band_spmv_plain(data, offsets, x_pad, left, row0):
    """y = the rows [row0, row0 + band) of A @ x, band = data.shape[1], for
    the band's diagonals `data` (ndiag, band) and the padded x_pad, which
    holds x[j] at left + j: one shifted slice of x_pad a diagonal, added in
    offset order in the promoted type of data and x_pad.  x_pad may be (n,)
    or (n, k): this is the plain version of both band kernels, also named
    dia_band_spmm_plain."""
    x_pad = promoted(data, x_pad)
    band = data.shape[1]
    base = left + row0
    acc = None
    for d, off in enumerate(offsets):
        seg = x_pad[base + off: base + off + band]
        term = _scale(data[d].to(x_pad.dtype), seg)
        acc = term if acc is None else acc + term
    return acc


dia_band_spmm_plain = dia_band_spmv_plain


def _check_band(data, offsets, x_pad, left, row0, reach, rank):
    """Raise on what the band kernels do not take.  They read x_pad without
    bounds tests, so its rows must cover every offset of every band row."""
    nd, band = data.shape
    if not (data.device == offsets.device == x_pad.device) \
            or x_pad.device.type != "cuda":
        raise InvalidInputException(
            f"DIA band kernel needs data, offsets and x_pad on one CUDA device "
            f"(got {data.device}, {offsets.device}, {x_pad.device})")
    if data.dtype not in _build.STORAGE or x_pad.dtype != _build.STORAGE[data.dtype][1]:
        raise InvalidInputException(
            f"DIA band kernel takes f32/bf16 data with f32 x, or f64 with f64 "
            f"(got {data.dtype} data, {x_pad.dtype} x)")
    if offsets.dtype != torch.int32 or offsets.shape != (nd,):
        raise InvalidInputException("offsets must be int32 of shape (ndiag,)")
    if data.stride(1) != 1 or data.stride(0) < band or not (
            offsets.is_contiguous() and x_pad.is_contiguous()):
        raise InvalidInputException(
            "DIA band kernel needs rows of data at unit stride, and "
            "contiguous offsets and x_pad")
    if x_pad.dim() != rank or (rank == 2 and x_pad.shape[1] < 1):
        raise InvalidInputException(f"x_pad of shape {tuple(x_pad.shape)}")
    lo, hi = reach
    if min(left, row0) < 0 or left + row0 + lo < 0 \
            or left + row0 + band + hi > x_pad.shape[0]:
        raise InvalidInputException(
            f"x_pad of {x_pad.shape[0]} rows does not cover band rows "
            f"[{row0}, {row0 + band}) at offsets {lo}..{hi} (left {left})")


def dia_band_spmv(data, offsets, x_pad, left, row0, reach,
                  block=_build.DEFAULT_BLOCK):
    """y = the rows [row0, row0 + band) of A @ x for one row band: data
    (ndiag, band), a copy of its own or a view of the whole matrix's data
    with rows at unit stride; int32 offsets (ndiag,); x_pad, which holds
    x[j] at left + j and zeros around it; reach, the least and the greatest
    offset (host ints: the kernel reads x_pad without bounds tests, so the
    wrapper checks it).  On CPU tensors this is the plain version; on CUDA
    tensors it launches the band kernel (a 2-D x_pad goes to
    dia_band_spmm), and raises on what the kernel does not take."""
    if x_pad.dim() == 2:
        return dia_band_spmm(data, offsets, x_pad, left, row0, reach, block)
    if x_pad.device.type == "cpu" and data.device.type == "cpu":
        return dia_band_spmv_plain(data, tuple(offsets.tolist()), x_pad, left, row0)
    _check_band(data, offsets, x_pad, left, row0, reach, 1)
    band = data.shape[1]
    y = torch.empty(band, dtype=x_pad.dtype, device=x_pad.device)
    if band:
        _build.launch("cusp_dia_band_spmv", data.dtype, x_pad.device, data,
                      offsets, data.shape[0], data.stride(0), x_pad, left, row0,
                      y, band, block)
        dia_band_spmv.launches += 1
    return y


dia_band_spmv.launches = 0


def dia_band_spmm(data, offsets, x_pad, left, row0, reach,
                  block=_build.DEFAULT_BLOCK):
    """Y = the rows [row0, row0 + band) of A @ X for one row band and a
    padded dense row-major block x_pad (rows, k): the plain version on CPU
    tensors, one launch of the band SpMM kernel for all k columns on CUDA
    tensors."""
    if x_pad.device.type == "cpu" and data.device.type == "cpu":
        return dia_band_spmv_plain(data, tuple(offsets.tolist()), x_pad, left, row0)
    _check_band(data, offsets, x_pad, left, row0, reach, 2)
    band, k = data.shape[1], x_pad.shape[1]
    y = torch.empty((band, k), dtype=x_pad.dtype, device=x_pad.device)
    if band:
        _build.launch("cusp_dia_band_spmm", data.dtype, x_pad.device, data,
                      offsets, data.shape[0], data.stride(0), x_pad, left, row0,
                      y, band, k,
                      *spmm_schedule(k, alignment(x_pad, y), x_pad.element_size()),
                      block)
        dia_band_spmm.launches += 1
    return y


dia_band_spmm.launches = 0


def build_dia(A, config):
    """Plan A (a DIA container) for the kernel: diagonal data in the storage
    dtype that `value_dtype` names, offsets as a device tensor, launched
    with `block_size` threads per block.  Complex values raise
    NotImplementedException here, at build time: the kernels take real
    values only."""
    if A.dtype.is_complex:
        raise NotImplementedException("DIA kernel supports real dtypes only")
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
