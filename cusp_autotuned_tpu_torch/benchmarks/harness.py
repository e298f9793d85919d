"""The port's one timer, the triad and the launch floor (counterpart of the
JAX repository's benchmarks/harness.py).

Two clocks, both CUDA events on the card:

  time_fn         seconds a call over back-to-back calls, the median of
                  samples: the host's work to launch each call is in it
                  wherever the host is slower than the kernels;
  time_fn_marginal
                  (marginal, per call): the marginal is the device time a
                  call, N calls captured into one CUDA graph and the
                  replay timed (graph_time_s, which the tuner ranks on);
  time_cold       the same pair with the call's working set kept out of
                  L2: the call's arrays come in copies, and the timing
                  rotates through enough of them that no call finds its
                  own in the 50 MB L2.  A call whose arrays fit in L2 and
                  is timed again and again reads them from L2, not from
                  HBM: its rate is not one to set against the triad's,
                  which streams 1 GiB.

On the TPU "marginal" meant the per-call time with each dispatch's fixed
relay cost cancelled by two chained timings; on the card the fixed cost of
a call is its launches, and a graph's replay leaves them out.  The relay
workarounds of the JAX harness (the read-back sink, the input
perturbations against the relay's cache, the chained fori_loop, the 8x
refine, setup_backend) have no counterpart.  Every timing function needs
the card and raises InvalidInputException for a CPU device: a CPU time
never stands in for the card's.

`launch_floor` is the kernel `csrc/launch_floor.cu`, the counterpart of the
Pallas copy_kernel (harness.py:279, launched at :284); `launch_floor_s`
times it both ways, and the difference is the host cost of one launch
through the port's ctypes wrappers.  The triad of harness.py:224 computes
the same function as the calibration's triad (`csrc/stream_triad.cu`), so
`stream_bandwidth_gbps` runs that kernel.
"""

from __future__ import annotations

import dataclasses
import itertools
import statistics

import numpy as np
import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.utils.config import resolve_device
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

SAMPLES, PER_SAMPLE = 25, 20       # timed samples, back-to-back calls a sample
WARMUP, REPEATS = 2, 10            # graph timing: calls before the capture, calls in it
FLOOR_SHAPE = (8, 128)             # the launch floor's tile, harness.py:283
COLD_L2S = 4                       # L2s of other copies between two calls of one copy


def card(args=(), device=None) -> torch.device:
    """The CUDA device that the timed call runs on: that of the first
    tensor among `args`, else `device`, else the CUDA device.  Raises
    InvalidInputException for any other device."""
    for a in args:
        if isinstance(a, torch.Tensor):
            device = a.device
            break
    device = resolve_device(device)
    if device.type != "cuda":
        raise InvalidInputException(
            f"the harness times the card; got {device}, and a CPU time does "
            f"not stand in for it")
    return device


def time_fn(f, *args, samples: int = SAMPLES, per_sample: int = PER_SAMPLE,
            device=None) -> float:
    """Seconds a call of f(*args): the median over `samples` of the CUDA
    event time of `per_sample` back-to-back calls, after a warm-up.  Events
    around a single call would also count the host's launch gap."""
    device = card(args, device)
    with torch.cuda.device(device):
        for _ in range(3):
            f(*args)
        torch.cuda.synchronize(device)
        times = []
        for _ in range(samples):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_sample):
                f(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / per_sample)
    return statistics.median(times) * 1e-3


def graph_time_s(f, *args, warmup: int = WARMUP, repeats: int = REPEATS,
                 device=None) -> float:
    """Device seconds a call of f(*args): `repeats` calls captured into one
    CUDA graph (after `warmup` calls on the capture's side stream, as
    capture asks), its replay timed by CUDA events, the best of three.
    f must be capture-safe: no host sync (.item(), .cpu()) inside it."""
    device = card(args, device)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(warmup):
            f(*args)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(repeats):
            f(*args)
    graph.replay()                      # the first replay uploads the graph
    best = float("inf")
    with torch.cuda.device(device):
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / repeats)
    return best * 1e-3


def time_fn_marginal(f, *args, samples: int = SAMPLES,
                     per_sample: int = PER_SAMPLE):
    """(marginal_s, per_call_s): the device seconds a call, from a CUDA
    graph's replay (graph_time_s), and the seconds a call back to back
    (time_fn), host gaps included."""
    return (graph_time_s(f, *args),
            time_fn(f, *args, samples=samples, per_sample=per_sample))


def cold_copies(nbytes: int, device) -> int:
    """Copies of a call's working set of `nbytes` that time_cold rotates
    through: enough that the other copies, touched between two calls of
    one copy, hold COLD_L2S times the card's L2 (1 where the set alone
    does).  With four L2s between, a line survives in L2 only if the
    replacement spares it four times over its size."""
    evict = COLD_L2S * torch.cuda.get_device_properties(device).L2_cache_size
    return 1 if nbytes >= evict else 1 + -(-evict // max(nbytes, 1))


def fresh(obj):
    """obj with every tensor in it cloned: a tensor, a container (a
    dataclass of tensors), or a dict, tuple or list of them; anything else
    as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: fresh(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.init})
    if isinstance(obj, dict):
        return {k: fresh(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(fresh(v) for v in obj)
    return obj


def cold_call(build, nbytes: int, device=None):
    """(call, copies): call() runs fn(*args) of build(i) -> (fn, args) for
    i = 0, 1, ..., copies - 1 in turn, each copy with arrays of its own
    (build(0) may hand back the originals), copies = cold_copies(nbytes).
    Each copy's last output is held until its next call, so that the
    outputs, too, rotate through buffers of their own."""
    device = card((), device)
    copies = cold_copies(nbytes, device)
    calls = [build(i) for i in range(copies)]
    held = [None] * copies
    turn = itertools.cycle(range(copies))

    def call():
        i = next(turn)
        fn, args = calls[i]
        held[i] = fn(*args)
        return held[i]

    return call, copies


def time_cold(build, nbytes: int, device=None, samples: int = SAMPLES,
              per_sample: int = PER_SAMPLE):
    """(marginal_s, per_call_s) of the call build(i) -> (fn, args) makes,
    as time_fn_marginal gives them, with the call's working set of `nbytes`
    (the bytes it reads and writes) out of L2, as it is where the data
    streams from HBM: the timings rotate through cold_call's copies, and
    the graph holds a whole number of rotations, so that no copy comes
    round sooner across two replays."""
    device = card((), device)
    call, copies = cold_call(build, nbytes, device)
    repeats = copies * -(-REPEATS // copies)
    return (graph_time_s(call, repeats=repeats, device=device),
            time_fn(call, samples=samples, per_sample=per_sample, device=device))


def stream_bandwidth_gbps(device=None) -> float:
    """The card's streaming rate in GB/s: the triad y = 0.5 y + 0.25 x
    (csrc/stream_triad.cu) over 1 GiB, 12 bytes an element."""
    from cusp_autotuned_tpu_torch.autotune import calibrate
    return calibrate.stream_gbps(card((), device))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float64).numpy()
    return np.asarray(a, np.float64)


def l2_error(y, expected) -> float:
    """||y - expected|| / ||expected|| in f64 (1 for a zero expected)."""
    y, expected = _host(y), _host(expected)
    denom = np.linalg.norm(expected)
    return float(np.linalg.norm(y - expected) / (denom if denom else 1.0))


def launch_floor_plain(x):
    """y = x * 1.0000001 + 0.125 in x's dtype, rounded after the product
    and after the sum."""
    return x * 1.0000001 + 0.125


def launch_floor(x):
    """y = x * 1.0000001 + 0.125 for an f32 tile of at most 1024 values.
    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernel (one block), and raises on what the kernel does not take."""
    if x.device.type == "cpu":
        return launch_floor_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not 1 <= x.numel() <= 1024 or not x.is_contiguous():
        raise InvalidInputException(
            f"launch floor kernel takes a contiguous f32 CUDA tensor of 1 to "
            f"1024 values (got {x.dtype} {tuple(x.shape)} on {x.device})")
    y = torch.empty_like(x)
    _build.launch("cusp_launch_floor", torch.float32, x.device, x, y, x.numel())
    launch_floor.launches += 1
    return y


launch_floor.launches = 0


def floor_tile(device) -> torch.Tensor:
    """The launch floor's input, harness.py:281's seeded (8, 128) f32 tile."""
    x = np.random.RandomState(9).randn(*FLOOR_SHAPE).astype(np.float32)
    return torch.from_numpy(x).to(device)


def launch_floor_s(device=None, samples: int = SAMPLES,
                   per_sample: int = PER_SAMPLE) -> dict:
    """The cost of one launch, from launch_floor on one (8, 128) f32 tile:
    {"per_call_s": back-to-back launches timed by events (the host enqueues
    each), "graph_s": a CUDA graph's replay a launch (the device's own
    cost), "host_s": their difference, the host cost of one launch through
    the port's ctypes wrapper beyond what the device hides}."""
    device = card((), device)
    x = floor_tile(device)
    graph = graph_time_s(launch_floor, x, repeats=100)
    per_call = time_fn(launch_floor, x, samples=samples, per_sample=per_sample)
    return {"per_call_s": per_call, "graph_s": graph,
            "host_s": max(per_call - graph, 0.0)}
