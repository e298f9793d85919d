"""Build and load the port's CUDA kernels.

The sources in `cusp_autotuned_tpu_torch/csrc/` are compiled by nvcc, on
first use, into one shared library with a plain C interface for Hopper
(sm_90a), and loaded with ctypes.  The library lands in
`cusp_autotuned_tpu_torch/_build/` under a name keyed by a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
reused.  Nothing here runs at import: the package imports on machines
without nvcc or a GPU, where the kernel wrappers take their plain versions
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # data, offsets, k, pitch, x, y, m, n, stream
    "cusp_dia_spmv": (_vp, _vp, _i32, _i64, _vp, _vp, _i32, _i32, _vp),
    # indptr, col, val, x, y, m, stream
    "cusp_csr_spmv": (_vp, _vp, _vp, _vp, _vp, _i32, _vp),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source on first use")


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
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(p) for p in files if p.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)      # atomic: a concurrent builder sees all or nothing
    lib = ctypes.CDLL(str(so))
    for stem, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "bf16", "f64"):
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


def launch(stem: str, store: torch.dtype, device: torch.device, *args) -> None:
    """Call `{stem}_{suffix}` on `device`'s current stream with `args`
    (tensors are passed by data pointer); raise if the launch failed."""
    lib = library()
    fn = getattr(lib, f"{stem}_{STORAGE[store][0]}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args), stream)
    if code != 0:
        raise RuntimeError(f"{stem} launch failed: "
                           f"{lib.cusp_error_string(code).decode()}")
