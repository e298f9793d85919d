"""The tuner engine (counterpart of cusp_autotuned_tpu/autotune/tuner.py).

Parity map to the fork:
  Tuner.tune_iteration   <- tuner.TuneIteration via cusp::ktt::multiply
                           (cusp/ktt/detail/ktt.inl:88-94): run the next
                           untried configuration once, record its time,
                           return its output; once the space is exhausted,
                           keep running the best configuration.
  Tuner.run              <- the fixed-configuration tuner.Run
                           (cusp/system/cuda/ktt/multiply.h:80-103).
  Tuner.tune             <- the offline tuner.Tune with reference
                           validation, searcher and stop condition
                           (multiply.h:106-153).
  reset_tuning           <- cusp::ktt::reset_tuning (ktt.inl:130-142).

A configuration is a dict of kernel parameters (kernels/variants.py);
"compiling" one builds its plan (host conversion, upload).  Built plans are
cached per (matrix signature, configuration) for the dynamic walk, and
results persist to a JSON cache keyed by the matrix signature, which names
the device.

Timing is one channel.  On the card: after `warmup` calls, `repeats`
back-to-back calls are captured once into a CUDA graph, and CUDA events
time the graph's replay, best of three.  The replay launches without the
host, so the time is the device's: the wrappers' host cost, which is
about the same for every configuration, would otherwise set the order
(the JAX package ranks on profiler device time for the same reason).  On
the CPU: the host clock, best of `repeats`.  Every ranking
(best_configuration, choose_format) reads that one field, duration_ms.  A
tuner made with timing_channel='cuda_events' raises for tensors off the
card rather than time them another way.

Only a configuration that cannot be planned is a result: a refused
conversion or exhausted card memory (DeviceLimitsExceeded), or a plan the
port does not take (NotImplementedException, CompilationFailed).  Any
other error, such as a kernel that does not build or launch, propagates.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from cusp_autotuned_tpu_torch.autotune.result import ResultStatus, TuningResult
from cusp_autotuned_tpu_torch.autotune.search import (
    DeterministicSearcher, Searcher, StopCondition,
)
from cusp_autotuned_tpu_torch.autotune.space import config_key, configurations_for
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

TUNABLE_FORMATS = ("dia", "ell", "ellr", "csr", "coo", "hyb")
CHANNELS = ("auto", "cuda_events")

_enabled = False
_global_tuner: Optional["Tuner"] = None


def enable() -> None:
    """Route eligible multiplies through the tuner (cusp::ktt::enable)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def get_tuner() -> "Tuner":
    """Lazy global tuner (cusp::ktt::get_tuner, ktt.inl:20-62)."""
    global _global_tuner
    if _global_tuner is None:
        from cusp_autotuned_tpu_torch.utils.config import get_config
        _global_tuner = Tuner(cache_path=get_config().tuning_cache)
    return _global_tuner


@functools.lru_cache(maxsize=None)
def device_name(device: torch.device) -> str:
    """The name the cache keys a device by: the card's name, or 'cpu'."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _tensors(A):
    """Every tensor of a container, nested parts (HYB) included."""
    for f in dataclasses.fields(A):
        v = getattr(A, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v)


def _content_digest(A) -> str:
    """A cheap content fingerprint: nnz plus strided samples of every
    tensor.  Plans hold the matrix data, so two matrices of one shape and
    pattern must not share cache entries.  It is kept on the container with
    its tensors' storage and version counters, which every in-place edit
    bumps, so an edited matrix is fingerprinted anew."""
    tensors = list(_tensors(A))
    stamp = tuple((t.data_ptr(), t._version) for t in tensors)
    cached = A.__dict__.get("_content_digest")
    if cached is not None and cached[0] == stamp:
        return cached[1]
    h = hashlib.sha1(str(A.nnz).encode())
    for t in tensors:
        flat = t.reshape(-1)
        sample = flat[:: max(1, flat.shape[0] // 64)][:64].detach().cpu()
        if sample.dtype == torch.bfloat16:
            sample = sample.float()
        h.update(sample.numpy().tobytes())
    digest = h.hexdigest()[:16]
    object.__setattr__(A, "_content_digest", (stamp, digest))
    return digest


def matrix_signature(A, x=None) -> str:
    """Cache key: format, shape, dtype, k for a 2-D right-hand side, the
    format's layout, a content fingerprint and the device's name."""
    parts = [A.format, f"{A.shape[0]}x{A.shape[1]}", f"dtype={A.dtype}"]
    if x is not None and x.dim() == 2:
        parts.append(f"k={x.shape[1]}")
    if A.format in ("coo", "csr"):
        parts.append(f"nnzp={A.col.shape[0]}")
    elif A.format == "dia":
        offs = np.asarray(A.offsets, np.int64).tobytes()
        parts.append(f"ndiag={len(A.offsets)},offs={zlib.crc32(offs):x}")
    elif A.format in ("ell", "ellr"):
        parts.append(f"width={A.width}")
    elif A.format == "hyb":
        parts.append(f"w={A.ell.width},coo={A.coo.col.shape[0]}")
    parts.append(_content_digest(A))
    parts.append(device_name(A.device).replace(" ", "_"))
    return ":".join(parts)


# the cost model reads the pattern back to the host: above this many
# entries the untuned pick and the dynamic walk do without it, as the JAX
# package's tuner does
MODEL_MAX_NNZ = 8_000_000


def model_applies(A) -> bool:
    return getattr(A, "nnz", 0) <= MODEL_MAX_NNZ


def _tolerance(dtype) -> float:
    """Validation bar of a precision class: f64, bf16 storage, else f32."""
    name = str(dtype)
    if "64" in name:
        return 1e-10
    if "16" in name:
        return 2e-2
    return 1e-4


def _sync(x) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Tuner:
    def __init__(self, cache_path: Optional[str] = None,
                 warmup: int = 2, repeats: int = 10,
                 measure: bool = True, timing_channel: str = "auto"):
        """measure=False: validation-only walks record the single validated
        run's wall time, build included, instead of measuring.
        timing_channel: 'auto' (CUDA events on the card, the host clock on
        the CPU) or 'cuda_events' (raises for tensors off the card)."""
        if timing_channel not in CHANNELS:
            raise ValueError(f"timing_channel {timing_channel!r}; one of {CHANNELS}")
        self.cache_path = cache_path
        self.warmup = warmup
        self.repeats = repeats
        self.measure = measure
        self.timing_channel = timing_channel
        # signature -> {config_key: TuningResult}
        self.results: Dict[str, Dict[str, TuningResult]] = {}
        self._built: Dict[tuple, Callable] = {}
        self._best_fn: Dict[str, Callable] = {}
        self._walk_order: Dict[str, List[Dict[str, Any]]] = {}
        if cache_path and os.path.exists(cache_path):
            self.load(cache_path)

    # -- persistence ---------------------------------------------------------

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.cache_path
        if not path:
            return
        payload = {sig: [r.to_json() for r in res.values()]
                   for sig, res in self.results.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            payload = json.load(f)
        for sig, results in payload.items():
            store = self.results.setdefault(sig, {})
            for r in results:
                tr = TuningResult.from_json(r)
                store[config_key(tr.configuration)] = tr

    # -- building, timing, execution -----------------------------------------

    def _get_fn(self, A, config: Dict[str, Any], x=None):
        from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
        key = (matrix_signature(A, x), config_key(config))
        fn = self._built.get(key)
        if fn is None:
            fn = self._built[key] = build_spmv(A, config)
        return fn

    def channel(self, x) -> str:
        """The channel that times calls on x: 'cuda_events' or 'wall'."""
        if x.device.type == "cuda":
            return "cuda_events"
        if self.timing_channel == "cuda_events":
            raise InvalidInputException(
                f"timing channel 'cuda_events' needs tensors on a CUDA "
                f"device (x is on {x.device})")
        return "wall"

    def _time(self, fn, x) -> float:
        """Milliseconds per call on this tuner's channel."""
        if self.channel(x) == "cuda_events":
            return self._time_graph(fn, x)
        for _ in range(self.warmup):
            fn(x)
        best = float("inf")
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            fn(x)
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    def _time_graph(self, fn, x) -> float:
        """Device milliseconds per call: `repeats` calls captured into one
        CUDA graph (after `warmup` calls on the capture's side stream, as
        capture asks), its replay timed by CUDA events, best of three."""
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                fn(x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(self.repeats):
                fn(x)
        graph.replay()                  # the first replay uploads the graph
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / self.repeats)
        return best

    def _execute(self, A, x, config, *, validate=None) -> TuningResult:
        """Build and run one configuration (parity: KTT ResultStatus, and
        the JAX package's mapping): a refused conversion or exhausted card
        memory is DeviceLimitsExceeded, a plan the port does not take
        CompilationFailed, a non-finite or failing output ComputationFailed
        or ValidationFailed.  Every other error propagates."""
        t0 = time.perf_counter()
        try:
            fn = self._get_fn(A, config, x)
            y = fn(x)
            _sync(x)
        except (FormatConversionException, torch.cuda.OutOfMemoryError) as e:
            return TuningResult(dict(config), ResultStatus.DeviceLimitsExceeded,
                                error=str(e)[:500])
        except NotImplementedException as e:
            return TuningResult(dict(config), ResultStatus.CompilationFailed,
                                error=str(e)[:500])
        compile_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(y).all()):
            return TuningResult(dict(config), ResultStatus.ComputationFailed,
                                compilation_ms=compile_ms,
                                error="non-finite output")
        if validate is not None and not validate(y):
            return TuningResult(dict(config), ResultStatus.ValidationFailed,
                                compilation_ms=compile_ms)
        try:
            duration = self._time(fn, x) if self.measure else compile_ms
        except torch.cuda.OutOfMemoryError as e:
            return TuningResult(dict(config), ResultStatus.DeviceLimitsExceeded,
                                compilation_ms=compile_ms, error=str(e)[:500])
        return TuningResult(dict(config), ResultStatus.Ok, duration_ms=duration,
                            compilation_ms=compile_ms)

    # -- public engine ---------------------------------------------------------

    def _dynamic_order(self, A, sig) -> List[Dict[str, Any]]:
        """The dynamic walk's order: the cost model's best-predicted impls
        first, since each step runs on the caller's path.  The model reads
        the pattern on the host, so above MODEL_MAX_NNZ entries the walk
        keeps the space's order."""
        order = self._walk_order.get(sig)
        if order is None:
            order = configurations_for(A)
            if model_applies(A):
                from cusp_autotuned_tpu_torch.autotune.cost_model import (
                    model_order_key)
                order = sorted(order, key=model_order_key(A))
            self._walk_order[sig] = order
        return order

    def tune_iteration(self, A, x):
        """Run the next untried configuration, in the cost model's order (or
        the best one once the space is exhausted), and return y = A @ x."""
        from cusp_autotuned_tpu_torch.kernels.variants import default_config
        self.channel(x)
        sig = matrix_signature(A, x)
        fast = self._best_fn.get(sig)
        if fast is not None:
            return fast(x)
        store = self.results.setdefault(sig, {})
        for config in self._dynamic_order(A, sig):
            ck = config_key(config)
            if ck not in store:
                result = store[ck] = self._execute(A, x, config)
                if result.is_valid():
                    return self._get_fn(A, config, x)(x)
                # a failed configuration: this call takes the default
                return self._get_fn(A, default_config(A, x), x)(x)
        best_fn = self._get_fn(A, self.best_configuration(A, x), x)
        self._best_fn[sig] = best_fn
        return best_fn(x)

    def run(self, A, x, configuration: Dict[str, Any]):
        """y = A @ x with a fixed configuration."""
        return self._get_fn(A, configuration, x)(x)

    def tune(self, A, x, reference_computation=None,
             searcher: Optional[Searcher] = None,
             stop_condition: Optional[StopCondition] = None) -> List[TuningResult]:
        """Offline walk over the whole constrained space: every configuration
        is built, run, validated against `reference_computation(A, x)` when
        one is given (at its precision class's tolerance), and timed."""
        self.channel(x)
        order = (searcher or DeterministicSearcher()).order(configurations_for(A))
        if reference_computation is not None:
            expected = np.asarray(reference_computation(A, x), dtype=np.float64)
            scale = np.linalg.norm(expected) or 1.0
        sig = matrix_signature(A, x)
        store = self.results.setdefault(sig, {})
        out: List[TuningResult] = []
        if stop_condition is not None:
            stop_condition.initialize(len(order))
        for config in order:
            if stop_condition is not None and stop_condition.fulfilled():
                break
            validate = None
            if reference_computation is not None:
                vd = config.get("value_dtype")
                tol = _tolerance(vd if vd not in (None, 0, "none") else A.dtype)

                def validate(y, _tol=tol):
                    err = np.linalg.norm(
                        y.detach().cpu().double().numpy() - expected)
                    return err / scale <= _tol
            result = self._execute(A, x, config, validate=validate)
            store[config_key(config)] = result
            out.append(result)
            # drop the built plan: a walk of a large matrix would otherwise
            # hold every configuration's planned arrays on the card; the
            # winner is built again on first use
            self._built.pop((sig, config_key(config)), None)
            if len(out) % 10 == 0:
                self.save()
            if stop_condition is not None:
                stop_condition.update(result)
        self.save()
        return out

    def best_configuration(self, A, x=None) -> Dict[str, Any]:
        """The valid configuration of least duration_ms; with nothing
        measured, the cost model's pick (recommend_config) for a vector x,
        and the format's default configuration for a dense block x, which
        the model does not price, or above MODEL_MAX_NNZ entries."""
        ok = [r for r in self.results.get(matrix_signature(A, x), {}).values()
              if r.is_valid()]
        if ok:
            return dict(min(ok, key=lambda r: r.duration_ms).configuration)
        from cusp_autotuned_tpu_torch.kernels.variants import default_config
        if (x is None or x.dim() == 1) and model_applies(A):
            from cusp_autotuned_tpu_torch.autotune.cost_model import recommend_config
            return recommend_config(A, x)[0]
        return default_config(A, x)

    def reset_tuning(self, A=None) -> None:
        if A is None:
            self.results.clear()
            self._built.clear()
            self._best_fn.clear()
            self._walk_order.clear()
            return
        sig = matrix_signature(A)
        self.results.pop(sig, None)
        self._best_fn.pop(sig, None)
        self._walk_order.pop(sig, None)
        self._built = {k: v for k, v in self._built.items() if k[0] != sig}


# -- module-level conveniences (cusp::ktt free functions) ----------------------

def multiply(A, x, configuration: Optional[Dict[str, Any]] = None):
    tuner = get_tuner()
    if configuration is not None:
        return tuner.run(A, x, configuration)
    return tuner.tune_iteration(A, x)


def tune(A, x, reference_computation=None, searcher=None, stop_condition=None):
    return get_tuner().tune(A, x, reference_computation=reference_computation,
                            searcher=searcher, stop_condition=stop_condition)


def reset_tuning(A=None):
    get_tuner().reset_tuning(A)


def _ones(A):
    dtype = torch.float64 if A.dtype == torch.float64 else torch.float32
    return torch.ones(A.num_cols, dtype=dtype, device=A.device)


def tuned_operator(A, x=None, tune_first: bool = False, mesh=None):
    """The global tuner's best known configuration for A as a solver
    operator (operators.planned_operator): with no results for A, the cost
    model's pick.  tune_first=True walks the space first when it holds no
    results for A.  mesh= waits for the multi-device slice."""
    from cusp_autotuned_tpu_torch.operators import planned_operator
    if mesh is not None:
        raise NotImplementedException(
            "tuned_operator(mesh=...) needs the multi-device port")
    tuner = get_tuner()
    if tune_first and not tuner.results.get(matrix_signature(A, x)):
        tuner.tune(A, x if x is not None else _ones(A))
    return planned_operator(A, tuner.best_configuration(A, x))


def choose_format(A, x=None, formats=TUNABLE_FORMATS,
                  reference_computation=None, tuner: Optional[Tuner] = None):
    """Per-matrix format selection: convert A to each candidate format,
    walk each format's space, and return (container, configuration) of the
    least duration_ms, the field best_configuration ranks on.  Formats the
    conversion refuses are skipped."""
    from cusp_autotuned_tpu_torch.ops.convert import convert
    tuner = tuner or get_tuner()
    if x is None:
        x = _ones(A)
    best = None
    for fmt in formats:
        try:
            B = convert(A, fmt)
        except (FormatConversionException, NotImplementedException):
            continue
        tuner.tune(B, x, reference_computation=reference_computation)
        ok = [r for r in tuner.results.get(matrix_signature(B, x), {}).values()
              if r.is_valid()]
        if not ok:
            continue
        winner = min(ok, key=lambda r: r.duration_ms)
        if best is None or winner.duration_ms < best[2]:
            best = (B, dict(winner.configuration), winner.duration_ms)
    if best is None:
        raise NotImplementedException("no format produced a valid kernel")
    return best[0], best[1]
