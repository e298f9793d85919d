"""Measure the device constants on the current card (counterpart of
cusp_autotuned_tpu/autotune/calibrate.py).

`stream_gbps()` times the stream triad kernel (`csrc/stream_triad.cu`, which
replaces the JAX package's Pallas `triad_kernel`, calibrate.py:322) over a
working set of at least 1 GB, far past the 50 MB L2, and counts three
streams of bytes: the rate that every SpMV bound in the port is measured
against.  `gather_ns` and `segsum_ns` time PyTorch's own index_select and
index_add_, as the JAX package times XLA's gather and segment sum.
`tile_take_ns()` times the take probe (`csrc/take_probe.cu`, which
replaces the JAX package's Pallas probe `kernel`, calibrate.py:144): the
nanoseconds of one pass over a (128, 128) tile, 16,384 gathered elements,
from x staged in shared memory and, in its second instantiation, from x
read through L1/L2.  `calibrate()` measures them all, persists them as JSON
keyed by the card's name and applies those the cost model prices with (the
first three: no kernel of the port stages x for an SpMV any more, so the
take probe's price is reported, not priced) to `cost_model.DEVICE_MODEL`;
`load()` restores them for that card only.

The JAX package scales its probe by a TPU-fitted effective-pass factor and
guards the constants with an archived TPU model check; neither applies to
this card, and chip_smoke.py's `model` line checks the model's picks
against the card's walks.  Every
measurement here needs the card: a number taken on the CPU is never
written under these names.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from cusp_autotuned_tpu_torch.benchmarks import harness
from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

TRIAD_BYTES = 1 << 30              # x and y together
PROBE_ELEMENTS = 1 << 22           # gather and segment-sum probes
LANE = 128                         # a probe tile is LANE x LANE
TAKE_PASSES = (2, 18)              # the take probe's two points
TAKE_TILES = 4096                  # 256 MB of x: every SM busy, far past L2


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


def take_probe_planes(seed: int = 0):
    """One permutation of 0..127 for each row of each pass's plane, stacked:
    (max(TAKE_PASSES) * 128, 128) int32, as the JAX package's
    _take_probe_planes draws them from numpy's RandomState(seed)."""
    rng = np.random.RandomState(seed)
    planes = np.concatenate(
        [np.stack([rng.permutation(LANE) for _ in range(LANE)])
         for _ in range(max(TAKE_PASSES))], axis=0).astype(np.int32)
    return torch.from_numpy(planes)


def take_probe_plain(x, idx, passes):
    """The take probe's function: for each pass p in order, every row of
    every (128, 128) tile of x gathered through plane p (the same plane for
    every tile), scaled by 1 + 0.001 p and added to the sum where the index
    has the parity of p."""
    tiles = x.shape[0] // LANE
    acc = torch.zeros_like(x)
    for p in range(passes):
        ix = idx[p * LANE:(p + 1) * LANE].long().repeat(tiles, 1)
        g = torch.gather(x, 1, ix) * torch.tensor(1.0 + 0.001 * p, dtype=x.dtype)
        acc = torch.where(ix % 2 == p % 2, g + acc, acc)
    return acc


def take_probe(x, idx, passes, from_shared=True):
    """The take probe over x (G * 128, 128) f32 through the planes idx
    (at least passes * 128 rows of 128 int32).  On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel, from x staged in
    shared memory or (from_shared=False) read through L1/L2, and raises on
    what the kernel does not take."""
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return take_probe_plain(x, idx, passes)
    if x.device != idx.device or x.device.type != "cuda":
        raise InvalidInputException(
            f"take probe needs x and idx on one CUDA device "
            f"(got {x.device}, {idx.device})")
    if x.dtype != torch.float32 or idx.dtype != torch.int32:
        raise InvalidInputException("take probe takes f32 x and int32 idx")
    if x.dim() != 2 or x.shape[1] != LANE or x.shape[0] % LANE \
            or idx.dim() != 2 or idx.shape[1] != LANE \
            or not 0 <= passes <= idx.shape[0] // LANE:
        raise InvalidInputException(
            f"take probe takes x (G * 128, 128) and planes (P * 128, 128) with "
            f"passes <= P (got {tuple(x.shape)}, {tuple(idx.shape)}, {passes})")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise InvalidInputException("take probe needs contiguous tensors")
    out = torch.empty_like(x)
    _build.launch("cusp_take_probe", torch.float32, x.device, x, idx, out,
                  x.shape[0], passes, int(bool(from_shared)))
    take_probe.launches += 1
    return out


take_probe.launches = 0


def _ms(fn, device, reps) -> float:
    """CUDA-event milliseconds a call of fn(), `reps` calls back to back
    (benchmarks/harness.py:time_fn, the median of three such runs)."""
    return harness.time_fn(fn, samples=3, per_sample=reps, device=device) * 1e3


def stream_gbps(device=None, nbytes: int = TRIAD_BYTES, reps: int = 20) -> float:
    """GB/s of the triad kernel over x and y of nbytes together: 12 bytes
    moved per element (x read, y read and written)."""
    device = harness.card((), device)
    n = nbytes // 8
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(n, device=device, generator=gen)
    y = torch.rand(n, device=device, generator=gen)
    ms = _ms(lambda: stream_triad(x, y), device, reps)
    return 12 * n / (ms * 1e-3) / 1e9


def torch_op_ns(device=None) -> Dict[str, float]:
    """Nanoseconds per element of a random gather (index_select) and of a
    sorted segment sum (index_add_) over PROBE_ELEMENTS elements."""
    device = harness.card((), device)
    n = PROBE_ELEMENTS
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand(n, device=device, generator=gen)
    gidx = torch.randint(0, n, (n,), device=device, generator=gen)
    seg = torch.sort(torch.randint(0, n, (n,), device=device, generator=gen)).values
    out = torch.zeros(n, device=device)
    gather = _ms(lambda: torch.index_select(x, 0, gidx), device, 20)
    segsum = _ms(lambda: out.zero_().index_add_(0, seg, x), device, 20)
    return {"gather_ns": gather * 1e6 / n, "segsum_ns": segsum * 1e6 / n}


def tile_take_ns(device=None, tiles: int = TAKE_TILES, reps: int = 10,
                 from_shared: bool = True) -> float:
    """Nanoseconds of one take pass over one (128, 128) tile: the take
    probe timed at 2 and 18 passes over `tiles` tiles, the difference over
    16 passes and the tiles, so the streamed x, planes and output drop out."""
    device = harness.card((), device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(tiles * LANE, LANE, device=device, generator=gen)
    idx = take_probe_planes().to(device)
    lo, hi = (_ms(lambda p=p: take_probe(x, idx, p, from_shared), device, reps)
              for p in TAKE_PASSES)
    return max(hi - lo, 1e-9) * 1e6 / (tiles * (TAKE_PASSES[1] - TAKE_PASSES[0]))


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
    """Measure {stream_gbps, gather_ns, segsum_ns, tile_take_ns,
    tile_take_global_ns} on the card, save them keyed by its name (at
    `path`, else default_path) and apply those the cost model prices with
    to it (the global-x reading is reported beside the shared one)."""
    from cusp_autotuned_tpu_torch.autotune import cost_model
    device = harness.card((), device)
    consts = {"stream_gbps": stream_gbps(device), **torch_op_ns(device),
              "tile_take_ns": tile_take_ns(device),
              "tile_take_global_ns": tile_take_ns(device, from_shared=False)}
    save(consts, torch.cuda.get_device_name(device), path)
    cost_model.DEVICE_MODEL.update(
        {k: v for k, v in consts.items() if k in cost_model.DEVICE_MODEL})
    return consts
