"""Measure the device constants on the current card (counterpart of
cusp_autotuned_tpu/autotune/calibrate.py).

`stream_gbps()` times the stream triad kernel (`csrc/stream_triad.cu`, which
replaces the JAX package's Pallas `triad_kernel`, calibrate.py:322) over a
working set of at least 1 GB, far past the 50 MB L2, and counts three
streams of bytes: the rate that every SpMV bound in the port is measured
against.  `gather_ns` and `segsum_ns` time PyTorch's own index_select and
index_add_, as the JAX package times XLA's gather and segment sum.
`calibrate()` measures all three and persists them as JSON keyed by the
card's name; `load()` restores them for that card only.

Every measurement here needs the card: a number taken on the CPU is never
written under these names.  The JAX package's tile-take probe, its
effective-pass factor and its model-check guard price TPU primitives for
the cost model; they wait for the port's cost model.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.utils.config import resolve_device
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

TRIAD_BYTES = 1 << 30              # x and y together
PROBE_ELEMENTS = 1 << 22           # gather and segment-sum probes


def stream_triad_plain(x, y):
    """y = 0.5 * y + 0.25 * x, in place."""
    return y.mul_(0.5).add_(x, alpha=0.25)


def stream_triad(x, y, block=_build.DEFAULT_BLOCK):
    """y = 0.5 * y + 0.25 * x, in place, for 1-D f32 tensors.  On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel, and raises on what the kernel does not take."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return stream_triad_plain(x, y)
    if x.device != y.device or x.device.type != "cuda":
        raise InvalidInputException(
            f"triad kernel needs x and y on one CUDA device "
            f"(got {x.device}, {y.device})")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise InvalidInputException("triad kernel takes f32 x and y")
    if x.dim() != 1 or x.shape != y.shape:
        raise InvalidInputException(
            f"triad kernel takes 1-D x and y of one length "
            f"(got {tuple(x.shape)}, {tuple(y.shape)})")
    if not (x.is_contiguous() and y.is_contiguous()) \
            or x.data_ptr() % 16 or y.data_ptr() % 16:
        raise InvalidInputException(
            "triad kernel needs contiguous, 16-byte aligned tensors")
    _build.launch("cusp_stream_triad", torch.float32, x.device, x, y,
                  x.shape[0], block)
    stream_triad.launches += 1
    return y


stream_triad.launches = 0


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise InvalidInputException(
            f"calibration measures a card; got {device}, and a CPU number "
            f"does not stand in for it")
    return device


def _ms_per_call(fn, reps, warmup=2) -> float:
    """CUDA-event milliseconds per call over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def stream_gbps(device=None, nbytes: int = TRIAD_BYTES, reps: int = 20) -> float:
    """GB/s of the triad kernel over x and y of nbytes together: 12 bytes
    moved per element (x read, y read and written)."""
    device = _card(device)
    n = nbytes // 8
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, device=device, generator=gen)
    y = torch.rand(n, device=device, generator=gen)
    ms = _ms_per_call(lambda: stream_triad(x, y), reps)
    return 12 * n / (ms * 1e-3) / 1e9


def torch_op_ns(device=None) -> Dict[str, float]:
    """Nanoseconds per element of a random gather (index_select) and of a
    sorted segment sum (index_add_) over PROBE_ELEMENTS elements."""
    device = _card(device)
    n = PROBE_ELEMENTS
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand(n, device=device, generator=gen)
    gidx = torch.randint(0, n, (n,), device=device, generator=gen)
    seg = torch.sort(torch.randint(0, n, (n,), device=device, generator=gen)).values
    out = torch.zeros(n, device=device)
    gather = _ms_per_call(lambda: torch.index_select(x, 0, gidx), 20)
    segsum = _ms_per_call(lambda: out.zero_().index_add_(0, seg, x), 20)
    return {"gather_ns": gather * 1e6 / n, "segsum_ns": segsum * 1e6 / n}


def default_path(device_kind: str) -> str:
    """Where the constants persist: CUSP_TORCH_CALIBRATION if set, else
    beside the tuning cache (CUSP_TORCH_TUNING_CACHE), else in the
    package's build directory."""
    explicit = os.environ.get("CUSP_TORCH_CALIBRATION")
    if explicit:
        return explicit
    cache = os.environ.get("CUSP_TORCH_TUNING_CACHE")
    base = os.path.dirname(os.path.abspath(cache)) if cache else str(_build.BUILD_DIR)
    kind = device_kind.replace(" ", "_").replace("/", "_")
    return os.path.join(base, f"device_model_{kind}.json")


def save(constants: Dict[str, float], device_kind: str,
         path: Optional[str] = None) -> str:
    path = path or default_path(device_kind)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"device_kind": device_kind, "constants": constants,
                   "measured_at": time.strftime("%Y-%m-%d %H:%M:%S")}, f, indent=1)
    return path


def load(device_kind: str, path: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Constants persisted for this device kind, or None.  A file written
    for another kind is ignored."""
    path = path or default_path(device_kind)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        blob = json.load(f)
    if blob.get("device_kind") != device_kind:
        return None
    return {k: float(v) for k, v in blob["constants"].items()}


def calibrate(device=None, path: Optional[str] = None) -> Dict[str, float]:
    """Measure {stream_gbps, gather_ns, segsum_ns} on the card and save
    them keyed by its name (at `path`, else default_path)."""
    device = _card(device)
    consts = {"stream_gbps": stream_gbps(device), **torch_op_ns(device)}
    save(consts, torch.cuda.get_device_name(device), path)
    return consts
