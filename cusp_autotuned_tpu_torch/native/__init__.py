"""Native host code of the port, compiled with g++ on first use and loaded
with ctypes (counterpart of cusp_autotuned_tpu/native/__init__.py).

The sources here are the port's own copies of the sequential set-up
algorithms that the JAX package builds from the repository's `native/`:
the three-pass (Vanek) aggregator (`aggregate.cpp`), the RCM and
pseudo-peripheral orderings (`ordering.cpp`) and the Bridson AINV
factorisations (`ainv.cpp`).  At a million rows each takes minutes in
Python.  They build into one library in `cusp_autotuned_tpu_torch/_build/`
under a name keyed by a hash of the sources; where it cannot be built the
call raises, and nothing falls back to a Python loop.

Not ported: the JAX module's TPU planners (`plan_binned`,
`plan_colsort_main`, `color_cells`, `color_cells_mixed`, `route_cells`,
`color_cells_capped`, `routed_plan`), which lay entries out in VMEM tiles
and lanes; the port's kernels/*.py plan on the device for Hopper instead.
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

_SOURCES = tuple(sorted(Path(__file__).resolve().parent.glob("*.cpp")))
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_INT = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The native library, built on first call."""
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in _SOURCES)).hexdigest()[:16]
    so = BUILD_DIR / f"libcusp_native_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, so.name)
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 *map(str, _SOURCES), "-o", out],
                capture_output=True, text=True, timeout=240)
            if proc.returncode != 0:
                names = ", ".join(s.name for s in _SOURCES)
                raise RuntimeError(f"g++ failed to build {names}:\n{proc.stderr}")
            os.replace(out, so)     # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(so))
    lib.standard_aggregate.restype = ctypes.c_int32
    lib.standard_aggregate.argtypes = [ctypes.c_int32, _I32P, _I32P, _I32P, _I32P]
    lib.pseudo_peripheral.restype = ctypes.c_int32
    lib.pseudo_peripheral.argtypes = [ctypes.c_int32, _I32P, _I32P]
    lib.rcm.restype = None
    lib.rcm.argtypes = [ctypes.c_int32, _I32P, _I32P, _I32P]
    lib.ainv_spd.restype = ctypes.c_int64
    lib.ainv_spd.argtypes = [ctypes.c_int32, _I32P, _I32P, _F64P, ctypes.c_double,
                             _INT, _INT, _INT, _INT,
                             _I32P, _I32P, _F64P, ctypes.c_int64, _F64P]
    lib.ainv_nonsym.restype = ctypes.c_int64
    lib.ainv_nonsym.argtypes = [ctypes.c_int32, _I32P, _I32P, _F64P,
                                _I32P, _I32P, _F64P, ctypes.c_double,
                                _INT, _INT, _INT,
                                _I32P, _I32P, _F64P, ctypes.c_int64,
                                _I32P, _I32P, _F64P, ctypes.c_int64,
                                _F64P, _I64P, _I64P]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctype)


def _graph(indptr, col):
    """(n, indptr, col) as contiguous int32, checked against each other."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    if indptr.ndim != 1 or indptr.shape[0] < 1:
        raise ValueError("indptr must be 1-D with at least one entry")
    if col.shape[0] < indptr[-1]:
        raise ValueError("col is shorter than indptr[-1]")
    return indptr.shape[0] - 1, indptr, col


def _values(val, indptr):
    """val as contiguous f64, at least as long as indptr says."""
    val = np.ascontiguousarray(val, np.float64)
    if val.shape[0] < indptr[-1]:
        raise ValueError("val is shorter than indptr[-1]")
    return val


def standard_aggregate(indptr, col):
    """(aggregate id per vertex, root vertex per aggregate), int32, of the
    graph with CSR offsets `indptr` and columns `col`."""
    n, indptr, col = _graph(indptr, col)
    agg = np.empty(n, np.int32)
    roots = np.empty(n, np.int32)
    n_agg = library().standard_aggregate(
        n, _ptr(indptr, _I32P), _ptr(col, _I32P), _ptr(agg, _I32P),
        _ptr(roots, _I32P))
    return agg, roots[:n_agg]


def rcm(indptr, col):
    """The reverse Cuthill-McKee order: perm[i] = the old index of new
    position i (int32)."""
    n, indptr, col = _graph(indptr, col)
    perm = np.empty(n, np.int32)
    library().rcm(n, _ptr(indptr, _I32P), _ptr(col, _I32P), _ptr(perm, _I32P))
    return perm


def pseudo_peripheral(indptr, col) -> int:
    """A vertex of (near-)maximal eccentricity (George-Liu)."""
    n, indptr, col = _graph(indptr, col)
    return int(library().pseudo_peripheral(n, _ptr(indptr, _I32P), _ptr(col, _I32P)))


def _capacity_rounds(val, n):
    """The factor buffers' first capacity; each refusal quadruples it."""
    cap = max(4 * (val.size + n), 1024)
    for _ in range(6):
        yield cap
        cap *= 4
    raise RuntimeError("AINV factors outgrew 4^6 times their first buffer")


def ainv_spd(indptr, col, val, drop_tol, nonzero_per_row, lin_dropping,
             lin_param, scaled):
    """The SPD factorisation of the symmetric matrix (indptr, col, val):
    (w_row, w_col, w_val) COO triplets of W and the pivots diag (ones when
    scaled)."""
    n, indptr, col = _graph(indptr, col)
    val = _values(val, indptr)
    diag = np.zeros(n, np.float64)
    for cap in _capacity_rounds(val, n):
        w_row, w_col = np.empty(cap, np.int32), np.empty(cap, np.int32)
        w_val = np.empty(cap, np.float64)
        nnz = library().ainv_spd(
            n, _ptr(indptr, _I32P), _ptr(col, _I32P), _ptr(val, _F64P),
            float(drop_tol), int(nonzero_per_row), int(lin_dropping),
            int(lin_param), int(scaled), _ptr(w_row, _I32P), _ptr(w_col, _I32P),
            _ptr(w_val, _F64P), cap, _ptr(diag, _F64P))
        if nnz >= 0:
            return w_row[:nnz], w_col[:nnz], w_val[:nnz], diag


def ainv_nonsym(indptr, col, val, at_indptr, at_col, at_val, drop_tol,
                nonzero_per_row, lin_dropping, lin_param):
    """The biconjugation of A (indptr, col, val) with A^T (at_*):
    ((z_row, z_col, z_val), (w_row, w_col, w_val), diag)."""
    n, indptr, col = _graph(indptr, col)
    _, at_indptr, at_col = _graph(at_indptr, at_col)
    if at_indptr.shape[0] != n + 1:
        raise ValueError("A and A^T differ in their number of rows")
    val, at_val = _values(val, indptr), _values(at_val, at_indptr)
    diag = np.zeros(n, np.float64)
    for cap in _capacity_rounds(val, n):
        z = (np.empty(cap, np.int32), np.empty(cap, np.int32), np.empty(cap, np.float64))
        w = (np.empty(cap, np.int32), np.empty(cap, np.int32), np.empty(cap, np.float64))
        z_nnz, w_nnz = np.zeros(1, np.int64), np.zeros(1, np.int64)
        rc = library().ainv_nonsym(
            n, _ptr(indptr, _I32P), _ptr(col, _I32P), _ptr(val, _F64P),
            _ptr(at_indptr, _I32P), _ptr(at_col, _I32P), _ptr(at_val, _F64P),
            float(drop_tol), int(nonzero_per_row), int(lin_dropping),
            int(lin_param),
            _ptr(z[0], _I32P), _ptr(z[1], _I32P), _ptr(z[2], _F64P), cap,
            _ptr(w[0], _I32P), _ptr(w[1], _I32P), _ptr(w[2], _F64P), cap,
            _ptr(diag, _F64P), _ptr(z_nnz, _I64P), _ptr(w_nnz, _I64P))
        if rc == 0:
            zn, wn = int(z_nnz[0]), int(w_nnz[0])
            return (tuple(a[:zn] for a in z), tuple(a[:wn] for a in w), diag)
