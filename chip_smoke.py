"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Three main paths, each driven with every kernel's launch count set to 0
just before it and read just after:

  cg.cu     the reference's cg.cu configuration: poisson5pt 1000x1000
            (1,000,000 unknowns), a via_dia planned operator, CG under a
            Monitor at rel-tol 1e-5 with at most 2000 iterations, then the
            true residual b - A x through the default CSR operator;
  autotune  the tuner's path: calibrate() (the stream triad and the
            gather/segment-sum probes), the exhaustive validated walk
            (tune) on poisson5pt 1000x1000 CSR and on a skewed 1M-row CSR,
            the cg.cu solve through tuned_operator (timed in turns with the
            via_dia solve), the dynamic multiply
            hook on a 65,536-row diagonal matrix, and choose_format over
            dia, ell, ellr, csr, coo and hyb;
  spmm      the block multiply: the tuner's walk on poisson5pt 1000x1000
            CSR with a seeded X (1,000,000 x 16) under its per-k signature,
            tuned_operator(A, X) applied to X, the multiply hook on an
            Array2d of X, the walk and tuned_operator on the skewed 1M-row
            matrix at k = 16, eigen.lobpcg (100 iterations) on the operator
            tuned for a (n, 3) block, and a 100x100 LOBPCG against the
            analytic eigenvalue and against the plain operator.

Phases:

  build        nvcc builds the kernels from cusp_autotuned_tpu_torch/csrc/
  triad        the stream triad kernel against its plain version, and the
               card's triad GB/s, the denominator of every bound below
  dia_spmv     the DIA kernel against its plain PyTorch version on the
               card, at the main path's shape (f32 and bf16 storage) and at
               the JAX package's DIA test shapes
  csr_spmv     the CSR kernel against its plain version: poisson5pt
               1000x1000 and a seeded 1M-row matrix with skewed row lengths
  binned_spmv, coo_spmv
               the row-binned and the nnz-balanced COO kernels against
               their plain versions on four matrices: poisson5pt 1000x1000,
               the skewed 1M-row matrix, a uniform random 1M x 1M matrix
               (~8 entries a row) and a power-law 1M-row matrix
  dia_spmm     the DIA SpMM kernel against its plain version: poisson5pt
               1000x1000 at k = 3, 16 and 128 in f32 and bf16 storage, and
               the JAX package's DIA SpMM test shapes
  binned_spmm, coo_spmm
               the row-binned and COO SpMM kernels against their plain
               versions at k = 16 on the four matrices above, and on the JAX
               package's SpMM test shapes
  cg           the cg.cu path; then a 100x100 solve through the kernel
               operator against one through the plain operator
  autotune     the autotune path
  spmm         the spmm path

Every SpMV and SpMM line gives the kernel's time per call (CUDA events
over back-to-back calls) and device time (torch.profiler, every kernel of
the call: the COO wrappers launch two), its useful GB/s and
their share of the triad's rate, the bound (useful bytes over the triad's
rate), the plain version's times and, where one PyTorch call computes the
same product, that call's time (cuSPARSE through torch.sparse_csr_tensor,
times a vector or the dense block, timed as a yardstick only; the port
never calls it).  Any failed check
raises, and the script exits non-zero.  It exits non-zero at once where
torch sees no CUDA device.  Its last two lines are the kernels' JSON record
and {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

DIA_RTOL, DIA_ATOL = 1e-5, 1e-4      # tests/test_pallas.py:22
CSR_RTOL, CSR_ATOL = 1e-4, 1e-4      # tests/test_pallas.py:97
RAIL_RTOL, RAIL_ATOL = 1e-4, 1e-4    # tests/test_pallas.py:161
SAMPLES, PER_SAMPLE = 25, 20         # timed samples per version and turn,
                                     # back-to-back launches per sample
RAIL_SAMPLES = 8                     # the 1M-row rail lines take fewer
SPMM_SAMPLES, SPMM_PER_SAMPLE = 3, 5  # and the SpMM lines fewer still: a
                                      # plain SpMM at 1M rows takes ~10-100 ms
# the least time of a function on an H100 SXM (data sheet, 700 W): its
# bytes over the memory rate or its f32 operations over the f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
FORMATS = ("dia", "ell", "ellr", "csr", "coo", "hyb")
SPMV_KERNELS = ("dia_spmv", "csr_spmv", "binned_spmv", "coo_spmv",
                "stream_triad")
SPMM_KERNELS = ("dia_spmm", "binned_spmm", "coo_spmm")
KERNELS = SPMV_KERNELS + SPMM_KERNELS
# the kernels each wrapper launches, each once a call (the COO wrappers'
# torch.zeros adds a fill kernel, which is PyTorch's own)
WRAPPER_KERNELS = {
    "dia_spmv": ("dia_spmv_kernel",), "csr_spmv": ("csr_spmv_kernel",),
    "binned_spmv": ("binned_spmv_kernel",),
    "coo_spmv": ("coo_chunk_kernel", "coo_fold_kernel"),
    "stream_triad": ("stream_triad_kernel",), "dia_spmm": ("dia_spmm_kernel",),
    "binned_spmm": ("binned_spmm_kernel",),
    "coo_spmm": ("coo_spmm_chunk_kernel", "coo_spmm_fold_kernel"),
}
EARLIER_VIA_DIA_MS = "0.36-0.70"     # PERF.md §5, H100 80GB HBM3, 700 W


def log(*args):
    print(*args, flush=True)


def median_ms(fn, samples=SAMPLES, per_sample=PER_SAMPLE):
    """Median over `samples` of the per-launch CUDA-event time of
    `per_sample` back-to-back launches, after a warm-up.  Events around a
    single launch would also count the host's launch gap while the device
    waits."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return statistics.median(times)


def kernel_name(key):
    """A profiler key's function name, without namespace, template and
    arguments: 'void (anonymous namespace)::coo_spmm_fold_kernel<float>(...)'
    -> 'coo_spmm_fold_kernel'.  Used to find a wrapper's kernels; the
    records stay keyed by the full key, so kernels of one name and
    different templates are not merged."""
    base = key.replace("(anonymous namespace)", "").split("(")[0].split("<")[0]
    parts = base.replace("::", " ").split()
    return parts[-1] if parts else key[:40]


def device_kernels(fn, calls=PER_SAMPLE):
    """{profiler key: (device ms per call, launches per call)} that
    torch.profiler records over `calls` calls of fn.  A first step of
    `calls` calls warms the tracer up and is dropped: without it the
    profiler lost up to all launches of the first calls (PERF.md §7)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
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


def device_ms(fn, calls=PER_SAMPLE):
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
    work outlasts its kernels, this is below median_ms."""
    expect = wrapper_kernels(fn)
    kernels = device_kernels(fn, calls)
    if not kernels:
        return None, None, kernels
    if not expect:
        return sum(ms for ms, _ in kernels.values()), None, kernels
    seen = min(sum(n for key, (_, n) in kernels.items() if kernel_name(key) == name)
               for name in expect)
    if seen == 0:
        return None, 0.0, kernels
    return sum(ms / n for ms, n in kernels.values()), seen, kernels


def describe_device(t, seen):
    if t is None:
        return "device time not measured" + (
            " (a kernel of the call has no recorded launch)" if seen == 0 else "")
    return f"{t:.4f} ms device" + (
        f" (profiler recorded x{seen:.2f} of a kernel's launches)"
        if seen is not None and seen < 1 else "")


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time of the work on the
    card at its data-sheet rates."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def compare(name, kernel, plain, rtol, atol, useful_bytes, flops, triad_gbps,
            library=None, samples=SAMPLES, scale=None, per_sample=PER_SAMPLE):
    """Check kernel() against plain(), time both in turns (plain, kernel,
    kernel, plain), and library() beside them.  Returns the line's numbers.
    The check is |y - y_plain| <= atol + rtol * scale, where scale is
    |y_plain| unless given (the rails give each row's sum of |a_ij x_j|)."""
    y, yp = kernel(), plain()
    torch.cuda.synchronize()
    if y.shape != yp.shape or not torch.isfinite(y).all():
        raise RuntimeError(f"{name}: kernel output {tuple(y.shape)} is not "
                           f"finite or not of shape {tuple(yp.shape)}")
    diff = (y - yp).abs()
    err = float(diff.max())
    bar = atol + rtol * (yp.abs() if scale is None else scale)
    if not bool((diff <= bar).all()):
        raise RuntimeError(f"{name}: kernel differs from plain version, "
                           f"max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    p1, k1, k2, p2 = (median_ms(f, samples, per_sample)
                      for f in (plain, kernel, kernel, plain))
    ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
    library_ms = (median_ms(library, samples, per_sample) if library is not None
                  else None)

    def device(fn):
        return describe_device(*device_ms(fn, per_sample)[:2])

    gbps = useful_bytes / ms / 1e6
    log(f"  {name}: max_abs_err {err:.3e}; kernel {ms:.4f} ms/call, "
        f"{device(kernel)}, {gbps:.1f} GB/s useful = "
        f"{100 * gbps / triad_gbps:.1f} % of the triad, bound "
        f"{useful_bytes / triad_gbps / 1e6:.4f} ms; plain {plain_ms:.4f} "
        f"ms/call, {device(plain)}"
        + (f"; library {library_ms:.4f} ms/call" if library is not None else ""))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": useful_bytes, "flops": flops}


def seeded_x(n, seed, device):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    return torch.from_numpy(x).to(device)


def sparse_csr(A):
    """A as a torch.sparse_csr_tensor with f32 values, for the yardstick."""
    from cusp_autotuned_tpu_torch.ops.convert import convert
    C = convert(A, "csr")
    return torch.sparse_csr_tensor(C.indptr, C.col[:C.nnz], C.val[:C.nnz].float(),
                                   size=C.shape)


def library_spmv(A, x, S=None):
    """One PyTorch call computing the same product: CSR times a vector or a
    dense block through cuSPARSE, as a yardstick.  S: A's sparse_csr, where
    it is built already."""
    S = sparse_csr(A) if S is None else S
    return lambda: S @ x


def triad_phase(device):
    from cusp_autotuned_tpu_torch.autotune import calibrate

    gbps = calibrate.stream_gbps(device)
    log(f"triad: {gbps:.1f} GB/s (y = 0.5 y + 0.25 x, f32, x and y "
        f"{calibrate.TRIAD_BYTES >> 20} MiB together, 12 bytes an element)")
    n = calibrate.TRIAD_BYTES // 8
    x, y0 = torch.rand(n, device=device), torch.rand(n, device=device)
    yk, yp = y0.clone(), y0.clone()
    result = compare("stream_triad", lambda: calibrate.stream_triad(x, yk),
                     lambda: calibrate.stream_triad_plain(x, yp), 0.0, 0.0,
                     12 * n, 3 * n, gbps)
    return gbps, result


def dia_phase(device, triad_gbps):
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    from cusp_autotuned_tpu_torch.formats.dia import dia_matrix
    from cusp_autotuned_tpu_torch.kernels.dia import build_dia, dia_spmv_plain
    import scipy.sparse as sp

    rng = np.random.RandomState(1)
    unaligned = [-1000, -3, 0, 5, 999]
    cases = [
        ("poisson5pt 1000x1000 f32", lambda: gallery.poisson5pt(
            1000, 1000, format="dia", device=device), {}),
        ("poisson5pt 1000x1000 bf16", lambda: gallery.poisson5pt(
            1000, 1000, format="dia", device=device), {"value_dtype": "bfloat16"}),
        ("unaligned offsets n=1500", lambda: dia_matrix(
            unaligned, rng.uniform(0.5, 2.0, (5, 1500)), (1500, 1500),
            dtype=torch.float32, device=device), {}),
        ("rect wide 300x520", lambda: from_scipy(sp.diags(
            [rng.uniform(0.5, 2.0, 300) for _ in range(3)], [0, 150, 320],
            shape=(300, 520)), "dia", dtype=torch.float32, device=device), {}),
        ("rect tall 520x300", lambda: from_scipy(sp.diags(
            [rng.uniform(0.5, 2.0, 520) for _ in range(2)], [-220, 0],
            shape=(520, 300)), "dia", dtype=torch.float32, device=device), {}),
        ("poisson5pt 2000x2000 f32", lambda: gallery.poisson5pt(
            2000, 2000, format="dia", device=device), {}),
        ("poisson5pt 2000x2000 bf16", lambda: gallery.poisson5pt(
            2000, 2000, format="dia", device=device), {"value_dtype": "bfloat16"}),
    ]
    log("dia_spmv: kernel vs plain on the card, rtol 1e-5 atol 1e-4; useful "
        "bytes = k*rows_padded*sizeof(store) + (n+m)*4.  The 1000x1000 set "
        "(~28 MB in f32) fits the 50 MB L2; the 2000x2000 set (~112 MB) "
        "reads device memory.")
    results = {}
    for name, make, cfg in cases:
        A = make()
        fn = build_dia(A, cfg)
        data = fn.planned_arrays["data"]
        x = seeded_x(A.num_cols, 3, device)
        useful = (A.num_diagonals * A.rows_padded * data.element_size()
                  + (A.num_rows + A.num_cols) * 4)
        results[name] = compare(
            name, lambda: fn(x),
            lambda: dia_spmv_plain(data, A.offsets, x, A.shape),
            DIA_RTOL, DIA_ATOL, useful, 2 * A.num_diagonals * A.num_rows,
            triad_gbps, library_spmv(A, x))
    return results["poisson5pt 1000x1000 f32"]


def skewed_csr(n, seed, device):
    """A 1M-row matrix whose row lengths follow a heavy-tailed law (Pareto,
    1 to 4096 entries a row), with seeded random columns and values."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    rng = np.random.RandomState(seed)
    lengths = np.minimum(1 + (4 * rng.pareto(1.5, n)).astype(np.int64), 4096)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.randint(0, n, indptr[-1]).astype(np.int32)
    val = rng.uniform(-1.0, 1.0, indptr[-1]).astype(np.float32)
    return csr_matrix(indptr, col, val, (n, n), device=device)


def uniform_csr(n, per_row, seed, device):
    """An n x n matrix of n * per_row seeded uniform draws, duplicates
    merged: about per_row entries a row, scattered over all columns."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    rng = np.random.RandomState(seed)
    key = np.unique(rng.randint(0, n, n * per_row).astype(np.int64) * n
                    + rng.randint(0, n, n * per_row))
    row, col = key // n, key % n
    indptr = np.searchsorted(row, np.arange(n + 1))
    val = rng.uniform(-1.0, 1.0, key.size).astype(np.float32)
    return csr_matrix(indptr, col, val, (n, n), device=device)


def powerlaw_csr(n, nnz, seed, device):
    """tests/test_pallas.py:164-172 at n rows: Zipf(1.7) row lengths capped
    at n/2 and scaled to about nnz entries, random columns."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.7, n).astype(np.int64), n // 2)
    deg = np.maximum(deg * nnz // max(1, deg.sum()), 1)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    col = rng.integers(0, n, indptr[-1]).astype(np.int32)
    val = rng.standard_normal(indptr[-1]).astype(np.float32)
    return csr_matrix(indptr, col, val, (n, n), device=device)


def describe(name, A):
    lengths = torch.diff(A.indptr)
    log(f"  {name}: {A.num_rows} x {A.num_cols}, nnz {A.nnz}, rows of "
        f"{int(lengths.min())} to {int(lengths.max())} entries, "
        f"{int((lengths == 0).sum())} empty")


def csr_phase(device, triad_gbps, matrices):
    from cusp_autotuned_tpu_torch.kernels.csr import build_csr, csr_spmv_plain

    log("csr_spmv: kernel vs plain on the card, rtol 1e-4 atol 1e-4; useful "
        "bytes = nnz*(sizeof(val)+4) + (m+1)*4 + (n+m)*4")
    results = {}
    for name in ("poisson5pt 1000x1000 f32", "random 1M rows, skewed"):
        A = matrices[name]
        fn = build_csr(A, {})
        a = fn.planned_arrays
        x = seeded_x(A.num_cols, 4, device)
        useful = A.nnz * (a["val"].element_size() + 4) + (2 * A.num_rows + 1
                                                          + A.num_cols) * 4
        describe(name, A)
        results[name] = compare(
            name, lambda: fn(x),
            lambda: csr_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows),
            CSR_RTOL, CSR_ATOL, useful, 2 * A.nnz, triad_gbps,
            library_spmv(A, x))
    return results["poisson5pt 1000x1000 f32"]


def rails_phase(device, triad_gbps, matrices):
    from cusp_autotuned_tpu_torch.kernels.binned import (
        binned_spmv_plain, build_binned)
    from cusp_autotuned_tpu_torch.kernels.colsort import (
        build_colsort, coo_spmv_plain)

    log("binned_spmv / coo_spmv: kernels vs plain on the card, atol 1e-4 "
        "plus rtol 1e-4 of each row's sum of |a_ij x_j| (f32 rounding grows "
        "with the terms, not with their sum, and the power-law rows of 4e4 "
        "entries cancel); default plans (binned by length, hub_cap 1024; "
        "chunks of 128 entries); useful bytes, the matrix as CSR or COO once "
        "and x and y once: binned nnz*(4+4) + (m+1)*4 + (n+m)*4, coo "
        "nnz*(4+4+4) + (n+m)*4")
    out = {"binned_spmv": {}, "coo_spmv": {}}
    for name, A in matrices.items():
        describe(name, A)
        x = seeded_x(A.num_cols, 5, device)
        m, n, nnz = A.num_rows, A.num_cols, A.nnz
        library = library_spmv(A, x)
        fc = build_colsort(A, {})
        c = fc.planned_arrays
        scale = coo_spmv_plain(c["row"], c["col"], c["val"].abs().double(),
                               x.abs().double(), m).float()
        fb = build_binned(A, {})
        a = fb.planned_arrays
        log(f"    bins (row_start, rows, lanes per row; 0 = a block): "
            f"{fb.plan_stats['bins']}")
        out["binned_spmv"][name] = compare(
            f"binned {name}", lambda: fb(x),
            lambda: binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"],
                                      a["bins"], x, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 8 + (m + 1) * 4 + (n + m) * 4, 2 * nnz,
            triad_gbps, library, RAIL_SAMPLES, scale)
        out["coo_spmv"][name] = compare(
            f"coo {name}", lambda: fc(x),
            lambda: coo_spmv_plain(c["row"], c["col"], c["val"], x, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 12 + (n + m) * 4, 2 * nnz, triad_gbps,
            library, RAIL_SAMPLES, scale)
        del fb, fc, a, c, scale
    return {k: v["poisson5pt 1000x1000 f32"] for k, v in out.items()}


def seeded_block(n, k, seed, device):
    X = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    return torch.from_numpy(X).to(device)


def dia_spmm_phase(device, triad_gbps):
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    from cusp_autotuned_tpu_torch.kernels.dia import build_dia, dia_spmv_plain
    import scipy.sparse as sp

    rng = np.random.RandomState(1)

    def banded(shape, offsets):
        return from_scipy(sp.diags([rng.uniform(0.5, 2.0, shape[0]) for _ in offsets],
                                   offsets, shape=shape),
                          "dia", dtype=torch.float32, device=device)

    big = gallery.poisson5pt(1000, 1000, format="dia", device=device)
    big_csr = sparse_csr(big)
    small = gallery.poisson5pt(40, 45, format="dia", device=device)
    cases = [(f"poisson5pt 1000x1000 {store} k={k}", big, cfg, k)
             for k in (3, 16, 128)
             for store, cfg in (("f32", {}), ("bf16", {"value_dtype": "bfloat16"}))]
    cases += [  # tests/test_pallas.py:376, :392, :1047
        ("poisson5pt 40x45 k=100", small, {}, 100),
        ("poisson5pt 40x45 k=130", small, {}, 130),
        ("rect wide 300x520 k=80", banded((300, 520), [0, 150, 320]), {}, 80),
        ("wide short 8x300 k=16", banded((8, 300), [0, 1]), {}, 16),
        ("rect tall 520x300 k=5", banded((520, 300), [-220, 0]), {}, 5),
    ]
    log("dia_spmm: kernel vs plain on the card, atol 1e-4 plus rtol 1e-4 of "
        "each (row, column)'s sum of |a_ij X_jc|; useful bytes = "
        "ndiag*rows_padded*sizeof(store) + (n+m)*k*4.  X at k = 128 is 512 MB.")
    results = {}
    for name, A, cfg, k in cases:
        fn = build_dia(A, cfg)
        data = fn.planned_arrays["data"]
        X = seeded_block(A.num_cols, k, 3, device)
        useful = (A.num_diagonals * A.rows_padded * data.element_size()
                  + (A.num_rows + A.num_cols) * k * 4)
        scale = dia_spmv_plain(data.abs().double(), A.offsets, X.abs().double(),
                               A.shape).float()
        results[name] = compare(
            name, lambda: fn(X),
            lambda: dia_spmv_plain(data, A.offsets, X, A.shape),
            RAIL_RTOL, RAIL_ATOL, useful, 2 * A.nnz * k, triad_gbps,
            library_spmv(A, X, big_csr if A is big else None), SPMM_SAMPLES,
            scale, SPMM_PER_SAMPLE)
        del X, scale
    return results["poisson5pt 1000x1000 f32 k=16"]


def all_hub_csr(n, device):
    """tests/test_pallas.py:489's matrix: 2-3 entries a row."""
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    import scipy.sparse as sp
    S = (sp.eye(n) + sp.diags(np.full(n - 1, 2.0), 1)
         + sp.diags(np.full(n - 1, 3.0), -1))
    return from_scipy(S, "csr", dtype=torch.float32, device=device)


def rails_spmm_phase(device, triad_gbps, matrices):
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.kernels.binned import (
        binned_spmv_plain, build_binned)
    from cusp_autotuned_tpu_torch.kernels.colsort import (
        build_colsort, coo_spmv_plain)

    log("binned_spmm / coo_spmm: kernels vs plain on the card, atol 1e-4 plus "
        "rtol 1e-4 of each (row, column)'s sum of |a_ij X_jc|; default plans; "
        "useful bytes: binned nnz*(4+4) + (m+1)*4 + (n+m)*k*4, coo "
        "nnz*(4+4+4) + (n+m)*k*4")
    cases = [(f"{name} k=16", A, {}, 16) for name, A in matrices.items()]
    small = [  # tests/test_pallas.py:250, :281, :473, :489
        ("poisson9pt 30x30", gallery.poisson9pt(30, 30, format="csr", device=device),
         {}, (3, 16)),
        ("power-law 500 rows hub_cap 8", powerlaw_csr(500, 5000, 4, device),
         {"hub_cap": 8}, (5,)),
        ("power-law 700 rows", powerlaw_csr(700, 7000, 14, device), {}, (3, 9)),
        ("all-hub 400 rows hub_cap 1", all_hub_csr(400, device), {"hub_cap": 1}, (3,)),
    ]
    cases += [(f"{name} k={k}", A, cfg, k) for name, A, cfg, ks in small for k in ks]
    out = {"binned_spmm": {}, "coo_spmm": {}}
    for name, A, cfg, k in cases:
        X = seeded_block(A.num_cols, k, 5, device)
        m, n, nnz = A.num_rows, A.num_cols, A.nnz
        library = library_spmv(A, X)
        fc = build_colsort(A, {})
        c = fc.planned_arrays
        scale = coo_spmv_plain(c["row"], c["col"], c["val"].abs().double(),
                               X.abs().double(), m).float()
        fb = build_binned(A, cfg)
        a = fb.planned_arrays
        out["binned_spmm"][name] = compare(
            f"binned {name}", lambda: fb(X),
            lambda: binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"],
                                      a["bins"], X, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 8 + (m + 1) * 4 + (n + m) * k * 4,
            2 * nnz * k, triad_gbps, library, SPMM_SAMPLES, scale, SPMM_PER_SAMPLE)
        out["coo_spmm"][name] = compare(
            f"coo {name}", lambda: fc(X),
            lambda: coo_spmv_plain(c["row"], c["col"], c["val"], X, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 12 + (n + m) * k * 4, 2 * nnz * k,
            triad_gbps, library, SPMM_SAMPLES, scale, SPMM_PER_SAMPLE)
        del fb, fc, a, c, scale, X, library
    return {k: v["poisson5pt 1000x1000 f32 k=16"] for k, v in out.items()}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def counters():
    from cusp_autotuned_tpu_torch.autotune.calibrate import stream_triad
    from cusp_autotuned_tpu_torch.kernels.binned import binned_spmm, binned_spmv
    from cusp_autotuned_tpu_torch.kernels.colsort import coo_spmm, coo_spmv
    from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv
    from cusp_autotuned_tpu_torch.kernels.dia import dia_spmm, dia_spmv
    return {"dia_spmv": dia_spmv, "csr_spmv": csr_spmv,
            "binned_spmv": binned_spmv, "coo_spmv": coo_spmv,
            "stream_triad": stream_triad, "dia_spmm": dia_spmm,
            "binned_spmm": binned_spmm, "coo_spmm": coo_spmm}


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def solve(op, b):
    """CG at rel-tol 1e-5, at most 2000 iterations: (x, monitor, solve s)."""
    from cusp_autotuned_tpu_torch import solvers
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, mon = solvers.cg(op, b, monitor=Monitor(b, 2000, 1e-5))
    torch.cuda.synchronize()
    return x, mon, time.perf_counter() - t0


def cgcu(A_csr, b):
    """The cg.cu path: plan the via_dia operator, solve, and take the true
    residual through the default CSR operator.  Returns (x, monitor,
    relative true residual, set-up s, solve s)."""
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops import blas

    t0 = time.perf_counter()
    op = planned_operator(A_csr, {"impl": "via_dia"})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x, mon, solve_s = solve(op, b)
    r = b - planned_operator(A_csr)(x)
    return x, mon, float(blas.nrm2(r) / blas.nrm2(b)), setup_s, solve_s


def cg_phase(device, A):
    from cusp_autotuned_tpu_torch import gallery, solvers
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

    n = A.num_rows
    b = torch.as_tensor(np.random.RandomState(0).rand(n), dtype=torch.float32,
                        device=device)
    cgcu(A, b)                                  # warm-up: allocator, cuBLAS
    reset_counts()
    x, mon, true_res, setup_s, solve_s = cgcu(A, b)
    launches = read_counts()
    its = mon.iteration_count()
    rel = mon.residual_norm() / mon.b_norm
    log(f"cg: poisson5pt 1000x1000 f32 via_dia, rtol 1e-5, limit 2000: "
        f"{its} iterations, converged {mon.converged()}, relative residual "
        f"{rel:.3e} (true {true_res:.3e}), set-up {setup_s:.3f} s, solve "
        f"{solve_s:.3f} s, {1e3 * solve_s / max(its, 1):.4f} ms/iteration; "
        f"launches {launches}")
    if x.shape != (n,) or not torch.isfinite(x).all():
        raise RuntimeError("cg: x is not finite or not of shape (n,)")
    # the bar is on the monitored residual; the true residual of an f32
    # solve drifts from it with the condition number (~4e5 here), so it is
    # reported and only required to be finite
    if not (np.isfinite(rel) and rel < 1e-2 and np.isfinite(true_res)):
        raise RuntimeError(f"cg: relative residual {rel} (true {true_res}) "
                           f"is not finite and below 1e-2")
    if launches["dia_spmv"] < its or launches["csr_spmv"] < 1:
        raise RuntimeError(f"cg: kernel launches {launches} do not cover "
                           f"{its} iterations and the residual check")

    # kernel operator against plain operator, and the solution against the
    # scipy oracle, on a small problem that converges
    S = gallery.poisson5pt(100, 100, format="csr", device=device)
    bs = torch.as_tensor(np.random.RandomState(1).rand(S.num_rows),
                         dtype=torch.float32, device=device)
    out = {}
    for dia_impl in ("cuda", "slices"):
        op = planned_operator(S, {"impl": "via_dia", "dia_impl": dia_impl})
        xs, ms = solvers.cg(op, bs, monitor=Monitor(bs, 2000, 1e-5))
        bh = bs.cpu().numpy()
        res = float(np.linalg.norm(bh - reference_spmv(S, xs)) / np.linalg.norm(bh))
        out[dia_impl] = (ms.iteration_count(), ms.converged(), res)
    log(f"cg: poisson5pt 100x100 (iterations, converged, oracle residual): "
        f"kernel {out['cuda']}, plain {out['slices']}")
    (ik, ck, rk), (ip, cp, rp) = out["cuda"], out["slices"]
    if not (ck and cp and abs(ik - ip) <= 2 and rk < 1e-2 and rp < 1e-2):
        raise RuntimeError("cg: 100x100 kernel and plain solves disagree")
    return launches, b, its


def check_statuses(where, results, vector_only=()):
    """Raise unless every result is Ok or a refused conversion, or, for an
    impl in `vector_only` walked with a block x, CompilationFailed."""
    from cusp_autotuned_tpu_torch.autotune import ResultStatus
    for r in results:
        if r.status in (ResultStatus.Ok, ResultStatus.DeviceLimitsExceeded) or (
                r.status == ResultStatus.CompilationFailed
                and r.configuration.get("impl") in vector_only):
            continue
        raise RuntimeError(f"autotune: {r.configuration} on {where}: "
                           f"{r.status.value} {r.error}")


def label(config):
    """An impl with the inner DIA impl of via_dia: 'via_dia/cuda'."""
    impl = config["impl"]
    return f"{impl}/{config['dia_impl']}" if impl == "via_dia" else impl


def walk(name, A, x, need=("binned", "colsort", "cuda")):
    """tune() over the whole space with validation against the oracle.
    Every result must be Ok or a refused conversion: every plan but the CSR
    kernel's takes a block x and every plan a vector, so CompilationFailed
    on the card is a fault except for the csr `cuda` impl on a block (the
    CSR kernel takes vectors only, as the JAX package's `pallas` impl).  A
    kernel that does not build or launch raises out of tune().  Each impl
    in `need` must validate.  The leaders' device times come with the
    profiler's reading of each of their kernels."""
    from cusp_autotuned_tpu_torch import autotune
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    t0 = time.perf_counter()
    results = autotune.tune(A, x, reference_computation=reference_spmv)
    log(f"autotune: tune({name}, {A.format}, x {tuple(x.shape)}): "
        f"{len(results)} configurations in {time.perf_counter() - t0:.1f} s")
    for r in results:
        log(f"    {r.status.value:20s} {r.duration_ms:9.4f} ms  "
            f"{json.dumps(r.configuration, sort_keys=True)}"
            + (f"  ({r.error[:80]})" if r.error else ""))
    check_statuses(name, results, ("cuda",) if x.dim() == 2 else ())
    valid = {label(r.configuration) for r in results if r.is_valid()} | \
        {r.configuration["impl"] for r in results if r.is_valid()}
    if not set(need) <= valid:
        raise RuntimeError(f"autotune: {name}: {need} must each validate; "
                           f"valid impls {sorted(valid)}")
    best = autotune.get_tuner().best_configuration(A, x)
    best_ms = min(r.duration_ms for r in results if r.is_valid())
    log(f"  winner: {best} at {best_ms:.4f} ms")
    # the tuner's channel times graph replays, the device's time; the
    # profiler's device time of the leading configurations checks it, and
    # its per-kernel reading shows whether it saw every kernel of a call
    for r in sorted((r for r in results if r.is_valid()),
                    key=lambda r: r.duration_ms)[:4]:
        fn = build_spmv(A, r.configuration)
        t, seen, kernels = device_ms(lambda: fn(x))
        log(f"    leader {r.duration_ms:.4f} ms tuned, {describe_device(t, seen)} ("
            + ", ".join(f"{kernel_name(k)} {ms:.4f} ms x{n:g} recorded"
                        for k, (ms, n) in kernels.items())
            + f"): {r.configuration}")
    return best


def autotune_phase(device, matrices, b, viadia_its):
    from cusp_autotuned_tpu_torch import autotune, gallery
    from cusp_autotuned_tpu_torch.autotune import calibrate, configurations_for
    from cusp_autotuned_tpu_torch.autotune.tuner import matrix_signature
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops.convert import convert
    from cusp_autotuned_tpu_torch.ops.multiply import multiply

    A = matrices["poisson5pt 1000x1000 f32"]
    reset_counts()
    t0 = time.perf_counter()
    consts = calibrate.calibrate(device)
    log(f"autotune: calibrate() {consts} in {time.perf_counter() - t0:.1f} s")
    for name in ("poisson5pt 1000x1000 f32", "random 1M rows, skewed"):
        walk(name, matrices[name], seeded_x(matrices[name].num_cols, 6, device))

    # the tuned solve against the via_dia one in turns (via_dia, tuned,
    # tuned, via_dia): the host's share of a CG iteration drifts within a
    # call, so only solves taken side by side compare
    ops = {"tuned": autotune.tuned_operator(A),
           "via_dia": planned_operator(A, {"impl": "via_dia"})}
    solve(ops["tuned"], b)                        # warm-up
    per_it = {"tuned": [], "via_dia": []}
    for name in ("via_dia", "tuned", "tuned", "via_dia"):
        x, mon, solve_s = solve(ops[name], b)
        its = mon.iteration_count()
        per_it[name].append(1e3 * solve_s / max(its, 1))
        if name != "tuned":
            continue
        tuned_its, tuned_rel = its, mon.residual_norm() / mon.b_norm
        if not torch.isfinite(x).all() or abs(its - viadia_its) > 2:
            raise RuntimeError(f"autotune: the tuned solve took {its} "
                               f"iterations against via_dia's {viadia_its}")
    log(f"autotune: cg.cu through tuned_operator "
        f"({autotune.get_tuner().best_configuration(A)}): {tuned_its} "
        f"iterations (via_dia {viadia_its}), relative residual "
        f"{tuned_rel:.3e}; ms/iteration in turns: "
        + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                    for k, v in per_it.items())
        + f" (earlier via_dia solves, PERF.md: {EARLIER_VIA_DIA_MS} ms/iteration)")

    D = gallery.make_diagonal_symmetric_matrix(65536, 65536, 64, 7, device=device)
    xd = seeded_x(D.num_cols, 7, device)
    expect = reference_spmv(D, xd)
    space = len(configurations_for(D))
    autotune.enable()
    try:
        for i in range(space + 3):
            y = multiply(D, xd).cpu().numpy()
            if not np.allclose(y, expect, rtol=1e-4, atol=1e-4):
                raise RuntimeError(f"autotune: hook call {i} differs from the "
                                   f"oracle by {np.abs(y - expect).max():.3e}")
    finally:
        autotune.disable()
    hooked = autotune.get_tuner().results[matrix_signature(D)]
    check_statuses("the multiply hook", hooked.values())
    recorded = len(hooked)
    log(f"autotune: multiply hook on make_diagonal_symmetric_matrix(65536, "
        f"65536, 64, 7): {space + 3} calls checked against the oracle, "
        f"{recorded} results for a space of {space}")
    if recorded != space:
        raise RuntimeError("autotune: the hook's results do not cover the space")

    xc = seeded_x(A.num_cols, 8, device)
    t0 = time.perf_counter()
    B, cfg = autotune.choose_format(A, xc, formats=FORMATS,
                                    reference_computation=reference_spmv)
    tuner = autotune.get_tuner()
    for fmt in FORMATS:
        results = tuner.results[matrix_signature(convert(A, fmt), xc)].values()
        check_statuses(f"choose_format's {fmt}", results)
        best = min((r for r in results if r.is_valid()),
                   key=lambda r: r.duration_ms)
        log(f"    {fmt:5s} best {best.duration_ms:.4f} ms {best.configuration}")
    y = build_spmv(B, cfg)(xc).cpu().numpy()
    ref = reference_spmv(A, xc)
    log(f"autotune: choose_format over {FORMATS} in "
        f"{time.perf_counter() - t0:.1f} s: {B.format} {cfg}")
    if not np.allclose(y, ref, rtol=1e-4, atol=1e-4):
        raise RuntimeError("autotune: choose_format's pick differs from the oracle")
    return read_counts(), consts


def check_block(name, Y, plain, scale):
    """Y against the plain product at the kernels' bar."""
    torch.cuda.synchronize()
    if Y.shape != plain.shape or not torch.isfinite(Y).all():
        raise RuntimeError(f"spmm: {name}: output {tuple(Y.shape)} is not finite "
                           f"or not of shape {tuple(plain.shape)}")
    diff = (Y - plain).abs()
    if not bool((diff <= RAIL_ATOL + RAIL_RTOL * scale).all()):
        raise RuntimeError(f"spmm: {name} differs from the plain product by "
                           f"{float(diff.max()):.3e}")
    return float(diff.max())


def lobpcg_bound(n):
    """The largest eigenvalue of poisson5pt n x n: 4 + 4 cos(pi / (n + 1))."""
    return 4 + 4 * np.cos(np.pi / (n + 1))


def spmm_phase(device, matrices):
    """The spmm path; returns the launch counts of its run."""
    from cusp_autotuned_tpu_torch import autotune, eigen, gallery
    from cusp_autotuned_tpu_torch.eigen.lobpcg import CHECK_EVERY
    from cusp_autotuned_tpu_torch.formats import Array2d
    from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops.multiply import multiply

    def plain_product(A, X):
        Y = csr_spmv_plain(A.row, A.col, A.val, X, A.num_rows)
        scale = csr_spmv_plain(A.row, A.col, A.val.abs().double(),
                               X.abs().double(), A.num_rows).float()
        return Y, scale

    A = matrices["poisson5pt 1000x1000 f32"]
    S = matrices["random 1M rows, skewed"]
    X = seeded_block(A.num_cols, 16, 9, device)
    XS = seeded_block(S.num_cols, 16, 10, device)
    X3 = seeded_block(A.num_cols, 3, 11, device)
    Y_plain, scale = plain_product(A, X)
    YS_plain, scale_s = plain_product(S, XS)
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()
    walk("poisson5pt 1000x1000 f32", A, X, need=("binned", "colsort", "via_dia/cuda"))
    op = autotune.tuned_operator(A, X)
    err = check_block("tuned_operator(A, X)", op(X), Y_plain, scale)
    best = autotune.get_tuner().best_configuration
    log(f"spmm: tuned_operator(A, X) runs {best(A, X)}: max abs err {err:.3e} "
        f"against the plain product")
    autotune.enable()
    try:
        Y = multiply(A, Array2d.from_dense(X))
    finally:
        autotune.disable()
    err = check_block("the multiply hook on an Array2d", Y, Y_plain, scale)
    log(f"spmm: the multiply hook on Array2d {tuple(X.shape)}: max abs err "
        f"{err:.3e}")
    walk("random 1M rows, skewed", S, XS, need=("binned", "colsort"))
    ops = autotune.tuned_operator(S, XS)
    err = check_block("tuned_operator(skewed, X)", ops(XS), YS_plain, scale_s)
    log(f"spmm: tuned_operator(skewed 1M, X) runs {best(S, XS)}: max abs err "
        f"{err:.3e}")
    del Y_plain, YS_plain, scale, scale_s, Y

    # LOBPCG's block is (n, 3): the operator tuned for it
    t0 = time.perf_counter()
    op3 = autotune.tuned_operator(A, X3, tune_first=True)
    log(f"spmm: tuned_operator(A, X3, tune_first=True) in "
        f"{time.perf_counter() - t0:.1f} s: {best(A, X3)}")
    eigen.lobpcg(op3, largest=True, maxiter=2)               # warm-up
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam, x, its = eigen.lobpcg(op3, largest=True, maxiter=100,
                               return_iterations=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the steps masked after the stop, to the end of their block, launch too
    steps = min(100, -(-its // CHECK_EVERY) * CHECK_EVERY)
    per_step = {k: (v - before[k]) / steps for k, v in read_counts().items()
                if v > before[k]}
    lam, bound = float(lam), lobpcg_bound(1000)
    log(f"spmm: lobpcg(poisson5pt 1000x1000, largest, maxiter 100): lambda "
        f"{lam:.7f} (bound 4 + 4 cos(pi/1001) = {bound:.7f}), {its} "
        f"iterations, {1e3 * wall / steps:.4f} ms/iteration; launches per "
        f"iteration {per_step}")
    # where an iteration's time goes: the device's kernels over 16 steps
    # against the host's wall time of the same 16 steps
    prof_steps = 16
    t0 = time.perf_counter()
    eigen.lobpcg(op3, largest=True, maxiter=prof_steps)
    torch.cuda.synchronize()
    wall16 = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(
        lambda: eigen.lobpcg(op3, largest=True, maxiter=prof_steps), calls=1)
    busy = sum(ms for ms, _ in kernels.values())    # a lower bound (§7)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"spmm: lobpcg, {prof_steps} steps: {wall16 / prof_steps:.4f} ms/iteration "
        f"wall, {busy / prof_steps:.4f} ms/iteration device "
        f"({100 * busy / wall16:.1f} % busy), "
        f"{sum(n for _, n in kernels.values()) / prof_steps:.1f} kernels/iteration; "
        "top, ms and launches per iteration, by the profiler's full key:")
    for key, (ms, n) in top:
        log(f"    {ms / prof_steps:.4f} ms x{n / prof_steps:g}  {key}")
    if x.shape != (A.num_rows,) or not torch.isfinite(x).all():
        raise RuntimeError("spmm: lobpcg's vector is not finite or not of shape (n,)")
    # the Rayleigh quotient never passes the largest eigenvalue; 7.99 is far
    # below where 100 steps end (7.9986 at 300 x 300 in a CPU rehearsal)
    if not 7.99 < lam <= bound * (1 + 1e-5):
        raise RuntimeError(f"spmm: lobpcg's lambda {lam} is not in (7.99, {bound}]")

    # a 100 x 100 solve to tol 1e-5: the analytic eigenvalue, and the same
    # solve through the plain operator
    B = gallery.poisson5pt(100, 100, format="csr", device=device)
    XB = seeded_block(B.num_cols, 3, 12, device)
    out = {}
    for name, opb in (("tuned", autotune.tuned_operator(B, XB, tune_first=True)),
                      ("plain", planned_operator(B, {"impl": "segsum"}))):
        lam_b, _, its_b = eigen.lobpcg(opb, largest=True, maxiter=1000, tol=1e-5,
                                       return_iterations=True)
        out[name] = (float(lam_b), its_b)
    exact = lobpcg_bound(100)
    log(f"spmm: lobpcg(poisson5pt 100x100, tol 1e-5) (lambda, iterations): "
        f"tuned {out['tuned']}, plain {out['plain']}, exact {exact:.7f}")
    (lk, ik), (lp, ip) = out["tuned"], out["plain"]
    if not (abs(lk - exact) <= 1e-4 * exact and abs(lp - exact) <= 1e-4 * exact
            and ik < 1000 and ip < 1000):
        raise RuntimeError("spmm: the 100x100 LOBPCG misses the analytic "
                           "eigenvalue or does not converge")
    launches = read_counts()
    log(f"spmm: path in {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch sees no CUDA device; the port's "
                 "kernels run only on a GPU")
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.kernels import _build
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True).stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process "
        f"a source)")

    triad_gbps, triad = triad_phase(device)
    records = {"stream_triad": triad, "dia_spmv": dia_phase(device, triad_gbps)}
    t0 = time.perf_counter()
    matrices = {
        "poisson5pt 1000x1000 f32": gallery.poisson5pt(1000, 1000, format="csr",
                                                       device=device),
        "random 1M rows, skewed": skewed_csr(1_000_000, 2, device),
        "uniform random 1M x 1M": uniform_csr(1_000_000, 8, 3, device),
        "power-law 1M rows": powerlaw_csr(1_000_000, 10_000_000, 4, device),
    }
    log(f"matrices built in {time.perf_counter() - t0:.1f} s")
    records["csr_spmv"] = csr_phase(device, triad_gbps, matrices)
    records.update(rails_phase(device, triad_gbps, matrices))
    records["dia_spmm"] = dia_spmm_phase(device, triad_gbps)
    records.update(rails_spmm_phase(device, triad_gbps, matrices))
    for name in ("uniform random 1M x 1M", "power-law 1M rows"):
        del matrices[name]

    cg_launches, b, viadia_its = cg_phase(
        device, matrices["poisson5pt 1000x1000 f32"])
    tuned_launches, _ = autotune_phase(device, matrices, b, viadia_its)
    spmm_launches = spmm_phase(device, matrices)
    log(f"launches: cg.cu path {cg_launches}; autotune path {tuned_launches}; "
        f"spmm path {spmm_launches}")
    missing = [k for k in SPMV_KERNELS if tuned_launches[k] < 1] + \
        [k for k in ("dia_spmv", "csr_spmv") if cg_launches[k] < 1] + \
        [k for k in SPMM_KERNELS if spmm_launches[k] < 1]
    if missing:
        raise RuntimeError(f"kernels not launched on their path: {missing}")

    sources = {
        "dia_spmv": ("dia_spmv.cu", "cusp_autotuned_tpu/kernels/pallas_dia.py:393"),
        "csr_spmv": ("csr_spmv.cu", "cusp_autotuned_tpu/kernels/pallas_csr.py:171"),
        "binned_spmv": ("binned_spmv.cu",
                        "cusp_autotuned_tpu/kernels/pallas_binned.py:193"),
        "coo_spmv": ("coo_spmv.cu", "cusp_autotuned_tpu/kernels/pallas_colsort.py:162"),
        "stream_triad": ("stream_triad.cu",
                         "cusp_autotuned_tpu/autotune/calibrate.py:322"),
        "dia_spmm": ("dia_spmm.cu", "cusp_autotuned_tpu/kernels/pallas_dia.py:381"),
        "binned_spmm": ("binned_spmm.cu",
                        "cusp_autotuned_tpu/kernels/pallas_binned.py:229"),
        "coo_spmm": ("coo_spmm.cu",
                     "cusp_autotuned_tpu/kernels/pallas_colsort.py:885"),
    }
    kernels = []
    for name in KERNELS:
        r = records[name]
        bound_ms, bound_by = bound(r["bytes"], r["flops"])
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cusp_autotuned_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": (cg_launches[name] + tuned_launches[name]
                         + spmm_launches[name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
