"""Native host code of the port, compiled with g++ on first use and loaded
with ctypes (counterpart of the aggregation part of
cusp_autotuned_tpu/native/__init__.py).

`aggregate.cpp` here is the port's own copy of the three-pass (Vanek)
aggregator that the JAX package builds from the repository's
`native/aggregate.cpp`: at a million rows the sequential algorithm takes
minutes in Python.  The library lands in `cusp_autotuned_tpu_torch/_build/`
under a name keyed by a hash of the source; where it cannot be built the
call raises, and nothing falls back to the Python loop.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from cusp_autotuned_tpu_torch.kernels._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "aggregate.cpp"
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def library() -> ctypes.CDLL:
    """The aggregator's shared library, built on first call."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libcusp_native_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, so.name)
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                 "-o", out], capture_output=True, text=True, timeout=240)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{proc.stderr}")
            os.replace(out, so)     # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(so))
    lib.standard_aggregate.restype = ctypes.c_int32
    lib.standard_aggregate.argtypes = [ctypes.c_int32, _I32P, _I32P, _I32P, _I32P]
    return lib


def standard_aggregate(indptr, col):
    """(aggregate id per vertex, root vertex per aggregate), int32, of the
    graph with CSR offsets `indptr` and columns `col`."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    n = indptr.shape[0] - 1
    if col.shape[0] < indptr[-1]:
        raise ValueError("col is shorter than indptr[-1]")
    agg = np.empty(n, np.int32)
    roots = np.empty(n, np.int32)
    n_agg = library().standard_aggregate(
        n, indptr.ctypes.data_as(_I32P), col.ctypes.data_as(_I32P),
        agg.ctypes.data_as(_I32P), roots.ctypes.data_as(_I32P))
    return agg, roots[:n_agg]
