"""Probe on the card: where does the routed SpMV's time go?  (Counterpart of
the JAX repository's benchmarks/routed_probe.py.)

    python -m cusp_autotuned_tpu_torch.benchmarks.routed_probe [name]

`name` is an entry of gallery.williams_suite(2.0), Economics by default
(the JAX probe's default, :140-141); LP is where routed lost most.  The
kernel `csrc/routed_probe.cu` (replacing the Pallas probe _probe_kernel,
routed_probe.py:44, launched at :116) is the shipped routed SpMV's row
walk (`csrc/rail_rows.cuh`, the body routed_spmv_kernel runs) with its
parts taken away one at a time, on the shipped plan (kernels/routed.py:
build_routed):

  full       the shipped body and the colsort2 hub pair: equal to
             routed_spmv bit for bit
  nohub      the shipped body without the hub pair (hub rows 0)
  loads      y[r] = sum of val + 1e-30 col over the row: values and
             indices streamed, x not read (the JAX loads, :65-66), hub
             rows 0: the traffic floor

each on two plans: the default (256 rows a block) and 512 rows a block.
The JAX stages were the TPU's in-lane takes; the port's routed kernel has none, and reads every x
through L1/L2.  The shipped build_routed is timed in f32 and in bf16 value
storage; the JAX pack8 knob (int8 index planes) is a TPU workaround and
has no counterpart.  Where the JAX probe printed its take passes and XLU
bound, this one prints the plan's long rows (a warp each) and the tail's
share.  Every row is timed with its working set out of L2
(harness.time_cold: Economics' 14 MB and LP's 23 MB fit in the 50 MB L2).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.colsort2 import colsort2_hub, hub_plain
from cusp_autotuned_tpu_torch.kernels.routed import _check, build_routed
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

MODES = ("full", "nohub", "loads")     # in the order of rail_rows.cuh's Mode
SUITE_SCALE = 2.0
# the default plan (256 rows a block), and 512 rows a block
CONFIGS = ({"block_size": 256}, {"block_size": 512})


def routed_probe_plain(arrays, x, shape, thr, mode):
    """The probe's function in PyTorch, on routed plan `arrays`."""
    if mode not in MODES:
        raise InvalidInputException(f"no routed probe mode {mode!r} (modes {MODES})")
    m, n = shape
    indptr, col, val = arrays["indptr"], arrays["col"], arrays["val"]
    lengths = torch.diff(indptr).long()
    row = torch.repeat_interleave(torch.arange(m, device=col.device), lengths)
    own = lengths[row] <= thr
    nnz = row.numel()
    if mode == "loads":
        terms = val[:nnz] + 1e-30 * col[:nnz].to(val.dtype)
    else:
        terms = val[:nnz] * torch.index_select(x, 0, col[:nnz])
    y = x.new_zeros(m).index_add_(0, row[own], terms[own])
    return hub_plain(col, val, arrays["hub"], x, y) if mode == "full" else y


def routed_probe(arrays, x, shape, thr, mode, block=_build.DEFAULT_BLOCK):
    """y of the probe `mode` through the routed plan `arrays` (build_routed's
    with f32 values, launched in blocks of `block` threads).  On CPU tensors
    this is the plain version; on CUDA tensors it launches
    routed_probe_kernel and, for full, the colsort2 hub pair into the same
    y, and raises on what the kernels do not take."""
    if mode not in MODES:
        raise InvalidInputException(f"no routed probe mode {mode!r} (modes {MODES})")
    a = arrays
    m, n = shape
    if x.device.type == "cpu" and a["val"].device.type == "cpu":
        return routed_probe_plain(a, x, shape, thr, mode)
    _check(a["indptr"], a["col"], a["val"], a["hub"], (a["long"],), x, shape, 1)
    if a["val"].dtype != torch.float32:
        raise InvalidInputException("routed probe takes f32 values")
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m:
        _build.launch("cusp_routed_probe", torch.float32, x.device, a["indptr"],
                      a["col"], a["val"], x, y, m, thr, a["long"],
                      a["long"].numel(), MODES.index(mode), block)
        routed_probe.launches += 1
        if mode == "full":
            colsort2_hub(a["col"], a["val"], a["hub"], x, y, block)
    return y


routed_probe.launches = 0


def build_probe(A, config, mode):
    """(fn(x) -> y, info) for A under the probe `mode`, on the shipped plan
    build_routed(A, config) in f32; info holds the plan's rows, entries,
    long rows and tail share."""
    if mode not in MODES:
        raise InvalidInputException(f"no routed probe mode {mode!r} (modes {MODES})")
    shipped = build_routed(A, {**config, "value_dtype": 0})
    arrays, st = shipped.planned_arrays, shipped.plan_stats
    block = _build.block_size(config)
    thr = st["hub_cap"]

    def fn(x):
        return routed_probe(arrays, x, A.shape, thr, mode, block)

    info = {"rows": A.shape[0], "cols": A.shape[1], "nnz": st["nnz"],
            "hub_cap": thr, "long_rows": st["long_rows"],
            "tail_share": st["tail"] / max(st["nnz"], 1)}
    fn.planned_arrays = arrays
    return fn, info


def useful_bytes(A) -> int:
    """A routed SpMV's least traffic: a value and a column index an entry,
    two indptr reads a row, x read and y written once."""
    m, n = A.shape
    return A.nnz * 8 + (m + 1) * 4 + (n + m) * 4


def suite_matrix(name, device, scale=None):
    """williams_suite(scale, SUITE_SCALE by default)'s entry `name` as an
    f32 CSR on `device`."""
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    from cusp_autotuned_tpu_torch.gallery.suite import williams_suite
    S = williams_suite(scale or SUITE_SCALE, names=[name])[name]
    return from_scipy(S.tocoo().astype(np.float32), "csr", dtype=torch.float32,
                      device=device)


def main(argv=None, stream_gbps=None):
    """Print the probe's table on the card for the suite entry argv[1]
    (Economics by default), for each plan of CONFIGS; returns {(config
    label, mode or shipped label): (device s a call, s a call)}; stream_gbps
    is the triad's rate, measured now if None."""
    from cusp_autotuned_tpu_torch.benchmarks import harness

    argv = sys.argv if argv is None else argv
    name = argv[1] if len(argv) > 1 else "Economics"
    device = harness.card(())
    A = suite_matrix(name, device)
    x = torch.from_numpy(np.random.RandomState(0).randn(A.num_cols)
                         .astype(np.float32)).to(device)
    if stream_gbps is None:
        stream_gbps = harness.stream_bandwidth_gbps(device)
    useful = useful_bytes(A)
    out = {}

    def row(key, label, make, note=""):
        """Time make(A_i)'s call on copy i of A and x, the working set out of
        L2 (harness.time_cold)."""
        def build(i):
            Ai, xi = (A, x) if i == 0 else (harness.fresh(A), x.clone())
            return make(Ai), (xi,)

        marg, call = harness.time_cold(build, useful, device, samples=5)
        out[key] = (marg, call)
        print(f"  {label:18s} {marg * 1e3:.4f} ms device {call * 1e3:.4f} ms/call "
              f"{useful / marg / 1e9:7.1f} GB/s useful{note}", flush=True)

    for config in CONFIGS:
        tag = ", ".join(f"{k} {v}" for k, v in config.items())
        for mode in MODES:
            fn, info = build_probe(A, config, mode)
            if mode == MODES[0]:
                print(f"routed_probe: {name} (williams_suite({SUITE_SCALE})) "
                      f"{info['rows']} x {info['cols']}, {info['nnz']} entries; "
                      f"{tag}: hub_cap {info['hub_cap']}, "
                      f"{info['long_rows']} long rows, tail "
                      f"{100 * info['tail_share']:.1f} %; useful {useful / 1e6:.1f} "
                      f"MB, bound {useful / stream_gbps / 1e6:.4f} ms at the "
                      f"triad's {stream_gbps:.1f} GB/s", flush=True)
            row((tag, mode), f"probe {mode}",
                lambda Ai, mode=mode: build_probe(Ai, config, mode)[0])
        for store in ("f32", "bfloat16"):
            cfg = config if store == "f32" else {**config, "value_dtype": store}
            row((tag, f"shipped {store}"), f"shipped {store}",
                lambda Ai, cfg=cfg: build_routed(Ai, cfg), " (f32-equiv)")
    return out

if __name__ == "__main__":
    main()
