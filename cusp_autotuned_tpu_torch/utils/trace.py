"""Call-tree tracing (counterpart of cusp_autotuned_tpu/utils/trace.py; the
rebuild of the reference's `grapple` intercepting execution policy,
performance/grapple/my_execution_policy.h: wrap every dispatched verb and
record a nested call tree with timings).

Usage:
    with trace() as t:
        cg(A, b)
    t.print()

A context manager patches the verbs' entry points (multiply,
generalized_spmv, generalized_spgemm, convert, transpose, elementwise,
spgemm and the BLAS reductions) in their modules and in the namespaces
that re-export them, and records each call's nesting and host wall time.
Work on the card is asynchronous: a call's time is the host's time to
launch it unless the call itself waits for the card; utils.profiling times
the device side.  A caller that imported a verb by name before the block
keeps the unpatched function.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time
from typing import Any, List, Optional


@dataclasses.dataclass
class TraceRecord:
    name: str
    detail: str
    depth: int
    duration_ms: float


class Trace:
    def __init__(self):
        self.records: List[TraceRecord] = []
        self._depth = 0

    def print(self, stream=None) -> None:
        stream = stream or sys.stdout
        stream.write(f"trace: {len(self.records)} calls\n")
        for r in self.records:
            stream.write(f"  {'  ' * r.depth}{r.name}({r.detail})"
                         f"  {r.duration_ms:.3f} ms\n")

    def total_ms(self, name: Optional[str] = None) -> float:
        return sum(r.duration_ms for r in self.records
                   if r.depth == 0 and (name is None or r.name == name))

    def counts(self) -> dict:
        out: dict = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0) + 1
        return out


def _describe(a: Any) -> str:
    shape = getattr(a, "shape", None)
    fmt = getattr(a, "format", None)
    if fmt and shape is not None and len(shape) == 2:
        return f"{fmt}<{shape[0]}x{shape[1]}>"
    if shape is not None:
        return "x".join(map(str, shape))
    return type(a).__name__


_PATCH_POINTS = [
    ("cusp_autotuned_tpu_torch.ops.multiply",
     ["multiply", "generalized_spmv", "generalized_spgemm"]),
    ("cusp_autotuned_tpu_torch.ops.convert", ["convert"]),
    ("cusp_autotuned_tpu_torch.ops.transpose", ["transpose"]),
    ("cusp_autotuned_tpu_torch.ops.elementwise", ["elementwise"]),
    ("cusp_autotuned_tpu_torch.ops.spgemm", ["spgemm"]),
    ("cusp_autotuned_tpu_torch.ops.blas", ["dot", "dotc", "nrm2", "axpy", "axpby"]),
]
# the namespaces that re-export the verbs: the package root and ops
_NAMESPACES = ("cusp_autotuned_tpu_torch", "cusp_autotuned_tpu_torch.ops")


@contextlib.contextmanager
def trace():
    """Record every traced verb call made inside the block."""
    t = Trace()
    saved = []

    def wrap(name, fn):
        def inner(*args, **kwargs):
            rec = TraceRecord(name, ", ".join(_describe(a) for a in args[:2]),
                              t._depth, 0.0)
            t.records.append(rec)
            t._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t._depth -= 1
                rec.duration_ms = (time.perf_counter() - t0) * 1e3
        inner.__name__ = name
        inner.__wrapped__ = fn
        return inner

    namespaces = [importlib.import_module(ns) for ns in _NAMESPACES]
    for mod_name, fns in _PATCH_POINTS:
        mod = importlib.import_module(mod_name)
        for fname in fns:
            fn = getattr(mod, fname)
            wrapped = wrap(fname, fn)
            for ns in [mod] + namespaces:
                if ns is mod or getattr(ns, fname, None) is fn:
                    saved.append((ns, fname, fn))
                    setattr(ns, fname, wrapped)
    try:
        yield t
    finally:
        for ns, fname, fn in reversed(saved):
            setattr(ns, fname, fn)
