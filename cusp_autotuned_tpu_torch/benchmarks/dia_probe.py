"""Probe on the card: what binds the DIA SpMV kernel?  (Counterpart of the
JAX repository's benchmarks/dia_probe.py.)

    python -m cusp_autotuned_tpu_torch.benchmarks.dia_probe

The kernel `csrc/dia_probe.cu` (replacing the Pallas probe_kernel,
dia_probe.py:27, launched at :71) is the shipped dia_spmv_kernel with parts
taken out; some modes are numerically wrong on purpose:

  full      the shipped kernel's body: equal to dia_spmv bit for bit
  noshift   every diagonal reads x[i], no shifted read (the JAX noshift,
            :33-34, which reads the block's own rows of its padded x):
            the memory floor of the data stream
  nodata    coefficients 1, no data stream (2 m 4 bytes)
  nobounds  x left-padded with zeros as the band kernel reads it, no
            0 <= j < n test

each swept over block = 128, 256, 512 and 1024 threads, on poisson5pt
1000x1000 f32 (5 diagonals, x of 1M): 28 MB of useful bytes, ~0.0091 ms at
a ~3070 GB/s triad.  `shipped` times build_dia itself in f32 and in bf16
storage (:109-116).  The JAX modes noroll and oneroll priced the TPU's lane
rolls, which the card does not have.

Every row is timed with its working set out of L2 (harness.time_cold:
the 28 MB fit in the 50 MB L2, and a call timed again and again on the
same arrays reads them from there, not from HBM).  One more row times the
shipped f32 kernel on one copy, L2-warm, to show what L2 residency is
worth.
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.dia import (
    _pad_rows, dia_band_spmv_plain, dia_spmv_plain,
)
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

MODES = ("full", "noshift", "nodata", "nobounds")
BLOCKS = (128, 256, 512, 1024)
GRID = 1000


def dia_probe_plain(data, offsets, x, shape, mode, left=0):
    """The probe's function in PyTorch.  offsets: host ints; x: (n,), or for
    `nobounds` the x padded with `left` zeros in front and enough behind."""
    m, n = shape
    if mode == "full":
        return dia_spmv_plain(data, offsets, x, shape)
    if mode == "noshift":
        xi = x.new_zeros(m)
        xi[:min(m, n)] = x[:min(m, n)]
        acc = None
        for d in range(len(offsets)):
            term = data[d, :m] * xi
            acc = term if acc is None else acc + term
        return acc
    if mode == "nodata":
        return dia_spmv_plain(torch.ones_like(data), offsets, x, shape)
    if mode == "nobounds":
        return dia_band_spmv_plain(data[:, :m], offsets, x, left, 0)
    raise InvalidInputException(f"no DIA probe mode {mode!r} (modes {MODES})")


def dia_probe(data, offsets, x, shape, mode, left=0, reach=None,
              block=_build.DEFAULT_BLOCK):
    """y of the probe `mode` for f32 diagonals `data` (ndiag, pitch) and
    int32 `offsets`; for `nobounds`, x is padded with `left` zeros in front
    and reach is (least offset, greatest offset) as host ints (the kernel
    reads x without bounds tests, so the wrapper checks its length, with
    no host sync).  On CPU tensors this is the plain version; on CUDA
    tensors it launches dia_probe_kernel, and raises on what it does not
    take."""
    if mode not in MODES:
        raise InvalidInputException(f"no DIA probe mode {mode!r} (modes {MODES})")
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_probe_plain(data, tuple(offsets.tolist()), x, shape, mode, left)
    m, n = shape
    if not (data.device == offsets.device == x.device) or x.device.type != "cuda":
        raise InvalidInputException("DIA probe needs data, offsets and x on one "
                                    "CUDA device")
    if data.dtype != torch.float32 or x.dtype != torch.float32 \
            or offsets.dtype != torch.int32:
        raise InvalidInputException("DIA probe takes f32 data and x, int32 offsets")
    if not (data.is_contiguous() and offsets.is_contiguous() and x.is_contiguous()) \
            or x.dim() != 1 or data.shape[1] < m or offsets.shape != data.shape[:1]:
        raise InvalidInputException(
            f"DIA probe shapes: data {tuple(data.shape)}, x {tuple(x.shape)}, "
            f"matrix {shape}")
    if mode == "nobounds":
        if reach is None or left + reach[0] < 0 or left + m + reach[1] > x.shape[0]:
            raise InvalidInputException(
                f"nobounds: x of {x.shape[0]} values does not cover rows < {m} "
                f"at offsets {reach} (left {left})")
    elif x.shape[0] != n:
        raise InvalidInputException(f"x of {x.shape[0]} values for {n} columns")
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    if m:
        _build.launch("cusp_dia_probe", torch.float32, x.device, data, offsets,
                      data.shape[0], data.shape[1], x, y, m, n, left,
                      MODES.index(mode), block)
        dia_probe.launches += 1
    return y


dia_probe.launches = 0


def build_probe(A, block, mode):
    """fn(xin) -> y for the DIA matrix A (f32) under the probe `mode` at
    `block` threads a block; fn.prepare(x) gives xin from x, once: x itself,
    or for `nobounds` x padded with zeros, so no pad is timed."""
    data = A.data.to(torch.float32).contiguous()
    offsets = torch.tensor(A.offsets, dtype=torch.int32, device=data.device)
    left = -min(0, min(A.offsets))
    m, n = A.shape
    right = max(0, m + max(A.offsets) - n)
    reach = (min(A.offsets), max(A.offsets))

    def fn(xin):
        return dia_probe(data, offsets, xin, A.shape, mode, left, reach, block)

    def prepare(x):
        return _pad_rows(x, left, right).contiguous() if mode == "nobounds" else x

    fn.prepare = prepare
    fn.planned_arrays = {"data": data, "offsets": offsets}
    return fn


def useful_bytes(A, mode) -> int:
    """The bytes the probe must move: the diagonals (none for nodata), x
    read and y written once."""
    data = 0 if mode == "nodata" else A.num_diagonals * A.rows_padded * 4
    return data + (A.num_rows + A.num_cols) * 4


def main(stream_gbps=None):
    """Print the probe's table on the card (stream_gbps: the triad's rate,
    measured now if None); returns {label: (device s a call, s a call)}."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.benchmarks import harness
    from cusp_autotuned_tpu_torch.kernels.dia import build_dia

    device = harness.card(())
    A = gallery.poisson5pt(GRID, GRID, format="dia", dtype=torch.float32,
                           device=device)
    x = torch.from_numpy(np.random.RandomState(0).randn(A.num_cols)
                         .astype(np.float32)).to(device)
    if stream_gbps is None:
        stream_gbps = harness.stream_bandwidth_gbps(device)
    full = useful_bytes(A, "full")
    print(f"dia_probe: poisson5pt {GRID}x{GRID} f32, offsets {list(A.offsets)}; "
          f"useful bytes {full / 1e6:.1f} MB, bound {full / stream_gbps / 1e6:.4f} "
          f"ms at the triad's {stream_gbps:.1f} GB/s", flush=True)
    out = {}

    def row(label, build, nbytes, working=None, cold=True):
        """Time build's call (nbytes: the rate's numerator; working: the
        bytes the call moves, nbytes by default)."""
        if cold:
            marg, call = harness.time_cold(build, working or nbytes, device,
                                           samples=5)
        else:
            fn, args = build(0)
            marg, call = harness.time_fn_marginal(fn, *args, samples=5)
        out[label] = (marg, call)
        print(f"  {label:34s} {marg * 1e3:.4f} ms device {call * 1e3:.4f} ms/call "
              f"{nbytes / marg / 1e9:8.1f} GB/s useful "
              f"({100 * nbytes / marg / 1e9 / stream_gbps:5.1f} % of the triad)",
              flush=True)

    def copies(make):
        """build(i) for harness.time_cold: make(A_i, x_i) on copy i."""
        def build(i):
            return make(*((A, x) if i == 0 else (harness.fresh(A), x.clone())))
        return build

    def probe(mode, block):
        def make(Ai, xi):
            fn = build_probe(Ai, block, mode)
            return fn, (fn.prepare(xi),)
        return make

    def shipped(cfg):
        return lambda Ai, xi: (build_dia(Ai, cfg), (xi,))

    for mode in MODES:
        for block in BLOCKS:
            row(f"{mode} block={block}", copies(probe(mode, block)),
                useful_bytes(A, mode))
    for cfg, size in (({}, 4), ({"value_dtype": "bfloat16"}, 2)):
        row(f"shipped {cfg.get('value_dtype', 'f32')} (f32-equiv bytes)",
            copies(shipped(cfg)), full,
            working=A.data.numel() * size + (A.num_rows + A.num_cols) * 4)
    row("shipped f32 L2-warm (one copy)", copies(shipped({})), full, cold=False)
    return out


if __name__ == "__main__":
    main()
