"""Build and load the port's CUDA kernels.

The sources in `cusp_autotuned_tpu_torch/csrc/` are compiled by nvcc, on
first use, for Hopper (sm_90a): one nvcc process per source, all started
together, then one link into a shared library with a plain C interface,
loaded with ctypes.  The library lands in `cusp_autotuned_tpu_torch/_build/`
under a name keyed by a hash of the sources and flags, so an edited source
builds anew and an unchanged one is reused.  Nothing here runs at import:
the package imports on machines without nvcc or a GPU, where the kernel
wrappers take their plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TYPED = ("f32", "bf16", "f64")
# symbol stem -> (argument types, storage suffixes); every function returns
# its launch's cudaError_t as an int
_SIGNATURES = {
    # data, offsets, k, pitch, x, y, m, n, block, stream
    "cusp_dia_spmv": ((_vp, _vp, _i32, _i64, _vp, _vp, _i32, _i32, _i32, _vp),
                      _TYPED),
    # data, offsets, k, pitch, x_pad, left, row0, y, band, block, stream
    "cusp_dia_band_spmv": ((_vp, _vp, _i32, _i64, _vp, _i64, _i64, _vp, _i32,
                            _i32, _vp), _TYPED),
    # data, offsets, ndiag, pitch, X_pad, left, row0, Y, band, k, width, cols,
    # rows, team_shift, block, stream
    "cusp_dia_band_spmm": ((_vp, _vp, _i32, _i64, _vp, _i64, _i64, _vp, _i32,
                            _i32, _i32, _i32, _i32, _i32, _i32, _vp), _TYPED),
    # indptr, col, val, x, y, m, nnz, tile_row, split_tile, split_row,
    # nsplit, carry_row, carry_val, block, stream
    "cusp_csr_spmv": ((_vp, _vp, _vp, _vp, _vp, _i32, _i64, _vp, _vp, _vp, _i32,
                       _vp, _vp, _i32, _vp), _TYPED),
    # indptr, col, val, x, y, m, hub_cap, long_rows, n_long, hub_rows, n_hub,
    # block, stream
    "cusp_binned_spmv": ((_vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp, _i32, _vp,
                          _i32, _i32, _vp), _TYPED),
    # row, col, val, nnz, x, y, m, carry_row, carry_val, vpt, block, stream
    "cusp_coo_spmv": ((_vp, _vp, _vp, _i64, _vp, _vp, _i32, _vp, _vp, _i32,
                       _i32, _vp), _TYPED),
    # data, offsets, ndiag, pitch, X, Y, m, n, k, width, cols, rows,
    # team_shift, block, stream
    "cusp_dia_spmm": ((_vp, _vp, _i32, _i64, _vp, _vp, _i32, _i32, _i32, _i32,
                       _i32, _i32, _i32, _i32, _vp), _TYPED),
    # col, val, walk rows, walk bounds, slots, X, Y, k, width, cols,
    # team_shift, block, stream
    "cusp_binned_spmm": ((_vp, _vp, _vp, _vp, _i32, _vp, _vp, _i32, _i32, _i32,
                          _i32, _i32, _vp), _TYPED),
    # row, col, val, nnz, X, Y, m, k, carry_row, carry_val, vpt, width, cols,
    # team_shift, block, stream
    "cusp_coo_spmm": ((_vp, _vp, _vp, _i64, _vp, _vp, _i32, _i32, _vp, _vp,
                       _i32, _i32, _i32, _i32, _i32, _vp), _TYPED),
    # indptr, col, val, x, y, m, V (0: one plane), thr, long_rows, n_long,
    # block, stream
    "cusp_colsort2_spmv": ((_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _vp,
                            _i32, _i32, _vp), _TYPED),
    # col, val, x, lo, hi, nv, rows, ptr, nh, part, y, block, stream
    "cusp_colsort2_hub": ((_vp, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _i32, _vp,
                           _vp, _i32, _vp), _TYPED),
    # indptr, col, val, X, Y, m, k, V, thr, width, cols, team_shift, block,
    # stream
    "cusp_colsort2_spmm": ((_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32,
                            _i32, _i32, _i32, _i32, _vp), _TYPED),
    # col, val, X, lo, hi, nv, rows, ptr, nh, part, Y, k, width, cols,
    # team_shift, block, stream
    "cusp_colsort2_hub_spmm": ((_vp, _vp, _vp, _vp, _vp, _i32, _vp, _vp, _i32,
                                _vp, _vp, _i32, _i32, _i32, _i32, _i32, _vp),
                               _TYPED),
    # indptr, col, val, x, y, m, thr, long_rows, n_long, block, stream
    "cusp_routed_spmv": ((_vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp, _i32, _i32,
                          _vp), _TYPED),
    # indptr, col, val, X, Y, m, k, thr, width, cols, team_shift, block,
    # stream
    "cusp_routed_spmm": ((_vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
                          _i32, _i32, _vp), _TYPED),
    # x, y, n, block, stream
    "cusp_stream_triad": ((_vp, _vp, _i64, _i32, _vp), ("f32",)),
    # x, idx, out, rows, passes, from_shared, stream
    "cusp_take_probe": ((_vp, _vp, _vp, _i64, _i32, _i32, _vp), ("f32",)),
    # x, y, n, stream
    "cusp_launch_floor": ((_vp, _vp, _i32, _vp), ("f32",)),
    # data, offsets, k, pitch, x, y, m, n, left, mode, block, stream
    "cusp_dia_probe": ((_vp, _vp, _i32, _i64, _vp, _vp, _i32, _i32, _i64, _i32,
                        _i32, _vp), ("f32",)),
    # data, offsets, ndiag, pitch, X, Y, m, n, k, mode, team, width, cols,
    # rows, team_shift, block, stream
    "cusp_dia_spmm_probe": ((_vp, _vp, _i32, _i64, _vp, _vp, _i32, _i32, _i32,
                             _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp),
                            ("f32",)),
    # indptr, col, val, x, y, m, thr, long_rows, n_long, mode, block, stream
    "cusp_routed_probe": ((_vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp, _i32, _i32,
                           _i32, _vp), ("f32",)),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source on first use")


def _run_all(cmds):
    """Run the commands side by side; raise on the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    files = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        digest.update(p.name.encode() + b"\0" + p.read_bytes())
    so = BUILD_DIR / f"libcusp_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc = _nvcc()
        sources = [p for p in files if p.suffix == ".cu"]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, p.stem + ".o") for p in sources]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                      for p, o in zip(sources, objs)])
            out = os.path.join(tmp, so.name)
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]])
            os.replace(out, so)  # atomic: a concurrent build sees all or nothing
    lib = ctypes.CDLL(str(so))
    for stem, (argtypes, suffixes) in _SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(lib, f"{stem}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.cusp_error_string.argtypes = (ctypes.c_int,)
    lib.cusp_error_string.restype = ctypes.c_char_p
    return lib


# storage dtype -> (symbol suffix, accumulation dtype of x and y)
STORAGE = {
    torch.float32: ("f32", torch.float32),
    torch.bfloat16: ("bf16", torch.float32),
    torch.float64: ("f64", torch.float64),
}


def accumulation(store: torch.dtype) -> torch.dtype:
    """The dtype of x, y and a plan's carries for values stored as `store`
    (`store` itself where no kernel takes it)."""
    return STORAGE[store][1] if store in STORAGE else store


_BOUND = {}   # (stem, storage dtype) -> the library's function


def _bind(stem: str, store: torch.dtype):
    fn = _BOUND[(stem, store)] = getattr(library(), f"{stem}_{STORAGE[store][0]}")
    return fn


def launch(stem: str, store: torch.dtype, device: torch.device, *args) -> None:
    """Call `{stem}_{suffix}` on `device`'s current stream with `args`
    (tensors are passed by data pointer); raise if the launch failed.  The
    bound function is looked up once per (stem, storage dtype), and the
    device is entered only when it is not the current one."""
    fn = _BOUND.get((stem, store)) or _bind(stem, store)
    argv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        code = fn(*argv, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            code = fn(*argv, torch._C._cuda_getCurrentRawStream(index))
    if code:
        raise RuntimeError(f"{stem} launch failed: "
                           f"{library().cusp_error_string(code).decode()}")


DEFAULT_BLOCK = 256


def block_size(config) -> int:
    """Threads per block of a launch: the `block_size` tuning axis (the
    fork's BLOCK_SIZE), 0 or unset for the default."""
    block = int((config or {}).get("block_size") or DEFAULT_BLOCK)
    if block % 32 or not 32 <= block <= 1024:
        raise NotImplementedException(
            f"block_size must be a multiple of 32 up to 1024 (got {block})")
    return block
