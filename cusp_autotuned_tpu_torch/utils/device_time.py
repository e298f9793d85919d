"""Device time of a call from a torch.profiler trace (counterpart of
cusp_autotuned_tpu/utils/device_time.py).

The JAX module reads each executable's device span from a jax.profiler
trace.  Here a call launches CUDA kernels, and the profiler records each
kernel's time on the card (CUPTI).  Two facts shape every function below:

- the profiler drops some launches' records, the first calls' most of all,
  so every capture runs one warm step first and drops it;
- a call may launch several kernels (the COO wrappers launch a chunk and a
  fold kernel), so a call's device time is the sum of its kernels.

The kernel wrappers count their launches (`launches`, one a launched
kernel, nowhere else); `counters()` names them, and `WRAPPER_KERNELS` the
kernels each launches.  Every function here reads the card: on a CPU
tensor nothing is recorded, and the readings are None or [], as the JAX
functions give on a backend without device spans.
"""

from __future__ import annotations

import collections
import statistics

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

CALLS = 20                  # calls a reading of device_kernels/device_ms takes
WINDOWS = 3                 # profiler windows a reading tries for a record
CALL_SPAN = "device_time call"

# the kernels each wrapper launches, each once a call (the CSR fold where
# the plan has two tiles or more; the COO wrappers' torch.zeros adds a fill
# kernel, which is PyTorch's own, for a plan with a run of more than
# GAP_ROWS empty rows)
WRAPPER_KERNELS = {
    "dia_spmv": ("dia_spmv_kernel",),
    "csr_spmv": ("csr_tile_kernel", "csr_fold_kernel"),
    "binned_spmv": ("binned_spmv_kernel",),
    "coo_spmv": ("coo_chunk_kernel", "coo_fold_kernel"),
    "stream_triad": ("stream_triad_kernel",), "dia_spmm": ("dia_spmm_kernel",),
    # the walk; its hub rows go through the colsort2 hub pair, counted there
    "binned_spmm": ("binned_spmm_walk_kernel",),
    "coo_spmm": ("coo_spmm_chunk_kernel", "coo_spmm_fold_kernel"),
    "colsort2_spmv": ("colsort2_main_kernel",),
    "colsort2_spmm": ("colsort2_spmm_main_kernel",),
    "routed_spmv": ("routed_spmv_kernel",), "routed_spmm": ("routed_spmm_kernel",),
    "take_probe": ("take_probe_kernel",),
    "dia_band_spmv": ("dia_band_spmv_kernel",),
    "dia_band_spmm": ("dia_band_spmm_kernel",),
    "launch_floor": ("launch_floor_kernel",), "dia_probe": ("dia_probe_kernel",),
    "dia_spmm_probe": ("dia_spmm_probe_kernel",),
    "routed_probe": ("routed_probe_kernel",),
    # the hub pair of a colsort2 plan with hub rows, and routed's tail
    "colsort2_hub": ("colsort2_hub_kernel", "colsort2_hub_fold_kernel"),
    "colsort2_hub_spmm": ("colsort2_spmm_hub_kernel", "colsort2_spmm_hub_fold_kernel"),
}


def counters():
    """{name: kernel wrapper}: every wrapper that counts its launches in
    its `launches` attribute."""
    from cusp_autotuned_tpu_torch.autotune.calibrate import stream_triad, take_probe
    from cusp_autotuned_tpu_torch.benchmarks import dia_probe, dia_spmm_probe, routed_probe
    from cusp_autotuned_tpu_torch.benchmarks.harness import launch_floor
    from cusp_autotuned_tpu_torch.kernels import colsort2, routed
    from cusp_autotuned_tpu_torch.kernels.binned import binned_spmm, binned_spmv
    from cusp_autotuned_tpu_torch.kernels.colsort import coo_spmm, coo_spmv
    from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv
    from cusp_autotuned_tpu_torch.kernels.dia import (
        dia_band_spmm, dia_band_spmv, dia_spmm, dia_spmv)
    return {"dia_spmv": dia_spmv, "csr_spmv": csr_spmv,
            "dia_band_spmv": dia_band_spmv, "dia_band_spmm": dia_band_spmm,
            "binned_spmv": binned_spmv, "coo_spmv": coo_spmv,
            "stream_triad": stream_triad, "dia_spmm": dia_spmm,
            "binned_spmm": binned_spmm, "coo_spmm": coo_spmm,
            "colsort2_spmv": colsort2.colsort2_spmv,
            "colsort2_spmm": colsort2.colsort2_spmm,
            "colsort2_hub": colsort2.colsort2_hub,
            "colsort2_hub_spmm": colsort2.colsort2_hub_spmm,
            "routed_spmv": routed.routed_spmv, "routed_spmm": routed.routed_spmm,
            "take_probe": take_probe, "launch_floor": launch_floor,
            "dia_probe": dia_probe.dia_probe,
            "dia_spmm_probe": dia_spmm_probe.dia_spmm_probe,
            "routed_probe": routed_probe.routed_probe}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def kernel_name(key):
    """A profiler key's function name, without namespace, template and
    arguments: 'void (anonymous namespace)::coo_spmm_fold_kernel<float>(...)'
    -> 'coo_spmm_fold_kernel'.  Used to find a wrapper's kernels; the
    records stay keyed by the full key, so kernels of one name and
    different templates are not merged."""
    base = key.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    parts = base.replace("::", " ").split()
    return parts[-1] if parts else key[:40]


def _activities():
    return [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_kernels(fn, calls=CALLS):
    """{profiler key: (device ms per call, launches per call)} that
    torch.profiler records over `calls` calls of fn.  A first step of
    `calls` calls warms the tracer up and is dropped: without it the
    profiler lost up to all launches of the first calls (PERF.md §7)."""
    _sync()
    with profile(activities=_activities(),
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            _sync()
            prof.step()
    out = {}
    for e in prof.key_averages():
        # ProfilerStep# is the schedule's own annotation, not a kernel
        if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep"):
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + e.self_device_time_total / 1e3 / calls,
                          n + e.count / calls)
    return out


def wrapper_kernels(fn):
    """The names of the kernels that fn's kernel wrappers launch in one
    call of fn, read from the wrappers' launch counts."""
    before = read_counts()
    fn()
    return {name for w, n in read_counts().items() if n > before[w]
            for name in WRAPPER_KERNELS[w]}


def device_ms(fn, calls=CALLS):
    """(device ms per call or None where not measured, the least share of
    an expected kernel's launches that the profiler recorded or None, the
    per-kernel records).  The time sums every kernel of the call (the fill,
    chunk and fold kernels of a COO call).  The profiler drops some
    launches' records (PERF.md §7).  Where fn launches kernel wrappers,
    each of its kernels runs once a call: the time is then the sum of each
    kernel's mean over its recorded launches, and it is not measured
    unless every kernel of those wrappers has a recorded launch.  Where fn
    launches no wrapper (a plain version) it is the recorded time over
    `calls`, a lower bound where records were dropped.  Where a call's host
    work outlasts its kernels, this is below the time of a call."""
    expect = wrapper_kernels(fn)
    for _ in range(WINDOWS):        # a window with no device record at all
        kernels = device_kernels(fn, calls)
        if kernels:
            break
    if not kernels:
        return None, None, kernels
    if not expect:
        return sum(ms for ms, _ in kernels.values()), None, kernels
    seen = min(sum(n for key, (_, n) in kernels.items() if kernel_name(key) == name)
               for name in expect)
    if seen == 0:
        return None, 0.0, kernels
    return sum(ms / n for ms, n in kernels.values()), seen, kernels


def kernels_a_call(fn, x):
    """CUDA kernels that one call of fn(x) launches (torch.profiler)."""
    fn(x)
    _sync()
    with profile(activities=_activities()) as prof:
        fn(x)
        _sync()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def capture_trace(fn, x, reps):
    """[(call, profiler key, device µs)] of every CUDA kernel that
    torch.profiler records over `reps` calls of fn(x), each call in a span
    of its own and followed by a synchronize, after a warm step of `reps`
    calls that is dropped (PERF.md §7: without it the profiler lost the
    first calls' launches).  A kernel belongs to the call whose span it
    starts in.  A window in which the profiler recorded no kernel at all
    is taken again, at most WINDOWS times, as device_ms does.  The JAX
    function chains y = fn(y) so that XLA cannot reuse a result; nothing
    is reused here, so every call takes x.  [] where nothing ran on a CUDA
    device (a CPU tensor, or no GPU)."""
    for _ in range(WINDOWS if torch.cuda.is_available() else 1):
        events = _capture(fn, x, reps)
        if events:
            break
    return events


def _capture(fn, x, reps):
    _sync()
    with profile(activities=_activities(),
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(reps):
            fn(x)
        _sync()
        prof.step()
        for i in range(reps):
            with record_function(f"{CALL_SPAN} {i}"):
                fn(x)
                _sync()
        prof.step()
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(("ProfilerStep", CALL_SPAN)):
                kernels.append((e.time_range.start, e.name,
                                e.time_range.end - e.time_range.start))
        elif e.name.startswith(CALL_SPAN):
            spans.append((e.time_range.start, int(e.name.rsplit(" ", 1)[1])))
    spans.sort()
    out = []
    for start, name, us in sorted(kernels):
        call = [c for s, c in spans if s <= start]
        out.append((call[-1] if call else spans[0][1] if spans else 0, name, us))
    return out


def _complete_calls(events):
    """{call: [(key, µs)]} of the calls whose kernels are those of the most
    common call (a call with a dropped record is left out)."""
    calls = collections.defaultdict(list)
    for call, name, us in events:
        calls[call].append((name, us))
    shapes = collections.Counter(tuple(sorted(n for n, _ in ks))
                                 for ks in calls.values())
    if not shapes:
        return {}
    common = shapes.most_common(1)[0][0]
    return {c: ks for c, ks in calls.items()
            if tuple(sorted(n for n, _ in ks)) == common}


def device_us_per_call(fn, x, reps: int = 8, span_name: str = None):
    """Median device time (µs) of one fn(x) call, summing the call's
    kernels, over the calls that the profiler recorded whole; None where no
    CUDA kernel was recorded (a CPU tensor), as the JAX function gives on a
    backend without device spans.  span_name: keep only the kernels whose
    profiler key holds this substring."""
    events = capture_trace(fn, x, reps)
    if span_name is not None:
        events = [e for e in events if span_name in e[1]]
    calls = _complete_calls(events)
    if not calls:
        return None
    return float(statistics.median(sum(us for _, us in ks) for ks in calls.values()))


def hlo_breakdown(fn, x, reps: int = 6, top: int = 12):
    """Device time of one fn(x) call by kernel: [(profiler key, µs a call,
    bytes, GB/s)], the `top` longest first, over the calls that the
    profiler recorded whole; [] where no CUDA kernel was recorded.  The
    JAX function reads each HLO's bytes_accessed from XLA; torch.profiler
    counts no bytes, and no kernel wrapper reports a kernel's own bytes,
    so bytes and GB/s are None (never 0): benchmarks/bytes_per_spmv.py
    counts a whole SpMV's useful bytes."""
    calls = _complete_calls(capture_trace(fn, x, reps))
    if not calls:
        return []
    total = collections.defaultdict(float)
    for ks in calls.values():
        for name, us in ks:
            total[name] += us
    rows = [(name, us / len(calls), None, None) for name, us in total.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]
