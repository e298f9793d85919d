"""Roofline profiling (counterpart of cusp_autotuned_tpu/utils/profiling.py,
the rebuild of the reference's KTT hardware-counter path, main.cu:560-663:
measured bytes against an analytic min_read_bytes model).

The card's counters are not read here (`ncu` is not at hand on every
machine); the analytic byte model is set against the triad's rate measured
in the same process, and `device_trace` captures a torch.profiler trace for
a deeper look.  Timing needs the card: profile_spmv raises for a CPU
device.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class RooflineReport:
    time_us: float
    model_bytes: int
    achieved_gbps: float
    stream_gbps: float
    roofline_fraction: float
    gflops: float

    def __str__(self):
        return (f"{self.time_us:.1f} us, {self.achieved_gbps:.1f} GB/s vs "
                f"stream {self.stream_gbps:.1f} GB/s "
                f"({self.roofline_fraction:.1%} of roofline), "
                f"{self.gflops:.2f} GFLOP/s")


def min_read_bytes(A) -> int:
    """Analytic minimum device-memory traffic of one SpMV (main.cu:560-580
    analogue, without the 32-byte sector quantization): the port's arrays
    once, x once and y once (benchmarks/bytes_per_spmv.py)."""
    from cusp_autotuned_tpu_torch.benchmarks.bytes_per_spmv import bytes_per_spmv
    return bytes_per_spmv(A)


def roofline_report(A, time_s: float, stream_gbps: float) -> RooflineReport:
    """The report of one SpMV of A that took time_s seconds on a card that
    streams at stream_gbps."""
    model = min_read_bytes(A)
    achieved = model / time_s / 1e9
    return RooflineReport(time_us=time_s * 1e6, model_bytes=model,
                          achieved_gbps=achieved, stream_gbps=stream_gbps,
                          roofline_fraction=achieved / stream_gbps,
                          gflops=2 * A.nnz / time_s / 1e9)


def profile_spmv(A, x, config=None, stream_gbps=None) -> RooflineReport:
    """Time A's SpMV under `config` (default_config(A, x) if None) on x's
    card (benchmarks/harness.py:time_fn) and report it against the triad's
    rate: stream_gbps if given, else measured now."""
    from cusp_autotuned_tpu_torch.benchmarks import harness
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv, default_config

    harness.card((x,))
    fn = build_spmv(A, config or default_config(A, x))
    t = harness.time_fn(fn, x)
    if stream_gbps is None:
        stream_gbps = harness.stream_bandwidth_gbps(x.device)
    return roofline_report(A, t, stream_gbps)


def kernel_speed_of_light(A, config=None, x=None) -> dict | None:
    """The port's price of A's plan under `config` (default_config(A, x) if
    None): the cost model's predicted µs of its impl class on this card
    (cost_model.predict, the calibrated DEVICE_MODEL), where the JAX
    package priced TPU tile-take passes at 136 ns each.  Returns {impl,
    label, pred_us, config}, or None where the model does not price the
    impl or refuses it for A."""
    from cusp_autotuned_tpu_torch.autotune import cost_model
    from cusp_autotuned_tpu_torch.kernels.variants import default_config

    config = dict(config or default_config(A, x))
    label = cost_model.label_of(A, config)
    pred = cost_model.predict(A, x, allow_low_precision=True).get(label, {})
    if "us" not in pred:
        return None
    return {"impl": config.get("impl"), "label": label, "pred_us": pred["us"],
            "config": config}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and the card into log_dir
    (a Chrome trace, for chrome://tracing, Perfetto or TensorBoard)."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
