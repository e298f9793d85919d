"""Probe on the card: what holds the DIA SpMM kernel at a quarter of the
triad's rate?  (Counterpart of the JAX repository's
benchmarks/dia_spmm_probe.py.)

    python -m cusp_autotuned_tpu_torch.benchmarks.dia_spmm_probe

The kernel `csrc/dia_spmm_probe.cu` (replacing the Pallas probe _kernel,
dia_spmm_probe.py:29, launched at :68) runs the shipped dia_spmm_kernel
and variants of it:

  shipped   the shipped body (csrc/dia_spmm_body.cuh) at the shipped
            schedule (kernels/dia.py, spmm_schedule): equal to dia_spmm bit
            for bit
  rows=R    the same body and schedule with R rows a lane (R = 1, 2, 4):
            equal to it too
  team=T    a warp a row, each lane T / 32 columns, with 8- or 16-byte
            loads where k allows (T = 32, 64, 128): equal to it too
  xtile     a block's rows of X staged once in shared memory for each
            cluster of nearby offsets, read there by every diagonal of the
            cluster: equal to it too
  nodata    coefficients 1, no data stream: wrong on purpose

The JAX probe set a concatenated X block against per-diagonal slices and
swept the TPU's VMEM budget; the questions on the card are how the threads
span X's columns and whether X's shifted rows come again from L1/L2.  The
plain version and cuSPARSE (torch.sparse_csr_tensor @ X) are timed beside
them as yardsticks, where :113 timed the XLA path.  Shapes: poisson5pt
1000x1000 at k = 3, 16 and 128 (useful ~44, ~148 and ~1044 MB), and the
JAX probe's own 300x300 at k = 128 (:96-97).  Every row is timed with its
working set out of L2 (harness.time_cold; only the 1000x1000 k = 128
shape is past four L2s on its own).
"""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.dia import (
    alignment, dia_spmv_plain, spmm_schedule,
)
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

MODES = ("shipped", "rows=1", "rows=2", "rows=4", "team=32", "team=64",
         "team=128", "xtile", "nodata")
SHAPES = ((1000, 3), (1000, 16), (1000, 128), (300, 128))     # (grid, k)
_KIND = {"shipped": 0, "rows": 0, "team": 1, "xtile": 2, "nodata": 3}


def _parse(mode):
    """(kernel mode number, team width or rows a lane) of a mode name."""
    if mode not in MODES:
        raise InvalidInputException(f"no DIA SpMM probe mode {mode!r} (modes {MODES})")
    kind, _, team = mode.partition("=")
    return _KIND[kind], int(team or 0)


def dia_spmm_probe_plain(data, offsets, X, shape, mode):
    """The probe's function in PyTorch: the DIA product of every mode but
    `nodata`, whose coefficients are 1.  offsets: host ints."""
    _parse(mode)
    if mode == "nodata":
        data = torch.ones_like(data)
    return dia_spmv_plain(data, offsets, X, shape)


def dia_spmm_probe(data, offsets, X, shape, mode, block=_build.DEFAULT_BLOCK):
    """Y (m, k) of the probe `mode` for f32 diagonals `data` (ndiag, pitch),
    int32 `offsets` and a row-major f32 block X (n, k).  On CPU tensors this
    is the plain version; on CUDA tensors it launches
    dia_spmm_probe_kernel, and raises on what it does not take."""
    kind, team = _parse(mode)
    if X.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmm_probe_plain(data, tuple(offsets.tolist()), X, shape, mode)
    m, n = shape
    if not (data.device == offsets.device == X.device) or X.device.type != "cuda":
        raise InvalidInputException("DIA SpMM probe needs data, offsets and X on "
                                    "one CUDA device")
    if data.dtype != torch.float32 or X.dtype != torch.float32 \
            or offsets.dtype != torch.int32:
        raise InvalidInputException("DIA SpMM probe takes f32 data and X, int32 "
                                    "offsets")
    if X.dim() != 2 or X.shape[0] != n or X.shape[1] < 1 or data.shape[1] < m \
            or offsets.shape != data.shape[:1] or not (
                data.is_contiguous() and offsets.is_contiguous()
                and X.is_contiguous()) or X.data_ptr() % 16:
        raise InvalidInputException(
            f"DIA SpMM probe shapes: data {tuple(data.shape)}, X "
            f"{tuple(X.shape)} (contiguous, 16-byte aligned), matrix {shape}")
    k = X.shape[1]
    Y = torch.empty((m, k), dtype=torch.float32, device=X.device)
    rows = team if mode.startswith("rows=") else None
    if m:
        _build.launch("cusp_dia_spmm_probe", torch.float32, X.device, data,
                      offsets, data.shape[0], data.shape[1], X, Y, m, n, k, kind,
                      team, *spmm_schedule(k, alignment(X, Y), 4, rows), block)
        dia_spmm_probe.launches += 1
    return Y


dia_spmm_probe.launches = 0


def build_probe(A, mode, block=_build.DEFAULT_BLOCK):
    """fn(X) -> Y for the DIA matrix A (f32) under the probe `mode`."""
    _parse(mode)
    data = A.data.to(torch.float32).contiguous()
    offsets = torch.tensor(A.offsets, dtype=torch.int32, device=data.device)

    def fn(X):
        return dia_spmm_probe(data, offsets, X, A.shape, mode, block)

    fn.planned_arrays = {"data": data, "offsets": offsets}
    return fn


def useful_bytes(A, k, mode="shipped") -> int:
    """The bytes the probe must move: the diagonals (none for nodata), X
    read and Y written once (dia_spmm_probe.py:100 counts the same)."""
    data = 0 if mode == "nodata" else A.num_diagonals * A.rows_padded * 4
    return data + (A.num_rows + A.num_cols) * k * 4


def main(stream_gbps=None):
    """Print the probe's table on the card for each (grid, k) of SHAPES
    (stream_gbps: the triad's rate, measured now if None); returns {(grid,
    k, label): (device s a call or None, s a call)}."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.tsparse import to_torch_sparse
    from cusp_autotuned_tpu_torch.benchmarks import harness

    device = harness.card(())
    if stream_gbps is None:
        stream_gbps = harness.stream_bandwidth_gbps(device)
    out = {}
    for grid, k in SHAPES:
        A = gallery.poisson5pt(grid, grid, format="dia", dtype=torch.float32,
                               device=device)
        X = torch.from_numpy(np.random.RandomState(2).randn(A.num_cols, k)
                             .astype(np.float32)).to(device)
        ref = dia_spmv_plain(A.data, A.offsets, X, A.shape)
        flops = 2 * A.nnz * k
        full = useful_bytes(A, k)
        print(f"dia_spmm_probe: poisson5pt {grid}x{grid} f32, k = {k}: {flops / 1e6:.0f} "
              f"MF, useful {full / 1e6:.1f} MB, bound {full / stream_gbps / 1e6:.4f} "
              f"ms at the triad's {stream_gbps:.1f} GB/s", flush=True)

        def copies(make):
            """build(i) for harness.cold_call: make(A_i, X_i) on copy i."""
            def build(i):
                return make(*((A, X) if i == 0 else (harness.fresh(A), X.clone())))
            return build

        def row(label, make, nbytes, err=None):
            marg, call = harness.time_cold(copies(make), full, device,
                                           samples=5, per_sample=10)
            out[(grid, k, label)] = (marg, call)
            print(f"  {label:22s} {marg * 1e3:.4f} ms device {call * 1e3:.4f} "
                  f"ms/call {flops / marg / 1e9:8.1f} GF/s {nbytes / marg / 1e9:7.1f} "
                  f"GB/s useful ({100 * nbytes / marg / 1e9 / stream_gbps:5.1f} % "
                  f"of the triad)" + ("" if err is None else f" err {err:.1e}"),
                  flush=True)

        def yardstick(label, make):
            # a call back to back only: cuSPARSE's workspace calls are not
            # known to be safe inside a graph capture
            call = harness.time_fn(harness.cold_call(copies(make), full,
                                                     device)[0],
                                   samples=3, per_sample=3, device=device)
            out[(grid, k, label)] = (None, call)
            print(f"  {label:22s} {call * 1e3:.4f} ms/call {flops / call / 1e9:8.1f} "
                  f"GF/s {full / call / 1e9:7.1f} GB/s useful", flush=True)

        def csr_of(Ai):
            return to_torch_sparse(Ai)

        for mode in MODES:
            fn = build_probe(A, mode)
            err = (harness.l2_error(fn(X), ref) if mode != "nodata" else None)
            row(mode, lambda Ai, Xi, mode=mode: (build_probe(Ai, mode), (Xi,)),
                useful_bytes(A, k, mode), err)
        yardstick("plain", lambda Ai, Xi: (
            lambda X_: dia_spmv_plain(Ai.data, Ai.offsets, X_, Ai.shape), (Xi,)))
        yardstick("cuSPARSE", lambda Ai, Xi: (csr_of(Ai).__matmul__, (Xi,)))
        del A, X, ref
    return out


if __name__ == "__main__":
    main()
