"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Two main paths, each driven with every kernel's launch count set to 0 just
before it and read just after:

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
            dia, ell, ellr, csr, coo and hyb.

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
  cg           the cg.cu path; then a 100x100 solve through the kernel
               operator against one through the plain operator
  autotune     the autotune path

Every SpMV line gives the kernel's time per call (CUDA events over
back-to-back calls) and device time (torch.profiler), its useful GB/s and
their share of the triad's rate, the bound (useful bytes over the triad's
rate), the plain version's times and, where one PyTorch call computes the
same product, that call's time (cuSPARSE through torch.sparse_csr_tensor,
timed as a yardstick only; the port never calls it).  Any failed check
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
from torch.profiler import ProfilerActivity, profile

DIA_RTOL, DIA_ATOL = 1e-5, 1e-4      # tests/test_pallas.py:22
CSR_RTOL, CSR_ATOL = 1e-4, 1e-4      # tests/test_pallas.py:97
RAIL_RTOL, RAIL_ATOL = 1e-4, 1e-4    # tests/test_pallas.py:161
SAMPLES, PER_SAMPLE = 25, 20         # timed samples per version and turn,
                                     # back-to-back launches per sample
RAIL_SAMPLES = 8                     # the 1M-row rail lines take fewer
# the least time of a function on an H100 SXM (data sheet, 700 W): its
# bytes over the memory rate or its f32 operations over the f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
FORMATS = ("dia", "ell", "ellr", "csr", "coo", "hyb")
KERNELS = ("dia_spmv", "csr_spmv", "binned_spmv", "coo_spmv", "stream_triad")


def log(*args):
    print(*args, flush=True)


def median_ms(fn, samples=SAMPLES):
    """Median over `samples` of the per-launch CUDA-event time of
    PER_SAMPLE back-to-back launches, after a warm-up.  Events around a
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
        for _ in range(PER_SAMPLE):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / PER_SAMPLE)
    return statistics.median(times)


def device_ms(fn):
    """Device time per call: the summed own time of the kernels that
    torch.profiler records over PER_SAMPLE calls, over PER_SAMPLE.  Where a
    call's host work outlasts its kernels, this is below median_ms."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PER_SAMPLE):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / PER_SAMPLE


def bound(nbytes, flops):
    """(ms, 'bytes' or 'operations'): the least time of the work on the
    card at its data-sheet rates."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def compare(name, kernel, plain, rtol, atol, useful_bytes, flops, triad_gbps,
            library=None, samples=SAMPLES, scale=None):
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
    p1, k1, k2, p2 = (median_ms(f, samples) for f in (plain, kernel, kernel, plain))
    ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])
    library_ms = median_ms(library, samples) if library is not None else None

    def device(fn):
        t = device_ms(fn)
        return f"{t:.4f} ms device" if t > 0 else "device time not measured"

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


def library_spmv(A, x):
    """One PyTorch call computing the same product: CSR times a vector
    through cuSPARSE, as a yardstick."""
    from cusp_autotuned_tpu_torch.ops.convert import convert
    C = convert(A, "csr")
    S = torch.sparse_csr_tensor(C.indptr, C.col[:C.nnz], C.val[:C.nnz].float(),
                                size=C.shape)
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
            triad_gbps)
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
        "chunks of 128 entries); useful bytes: binned nnz*(4+4) + (m+1)*4 + "
        "m*4 (perm) + (n+m)*4, coo nnz*(4+4+4) + (n+m)*4")
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
            RAIL_RTOL, RAIL_ATOL, nnz * 8 + (3 * m + 1 + n) * 4, 2 * nnz,
            triad_gbps, library, RAIL_SAMPLES, scale)
        out["coo_spmv"][name] = compare(
            f"coo {name}", lambda: fc(x),
            lambda: coo_spmv_plain(c["row"], c["col"], c["val"], x, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 12 + (n + m) * 4, 2 * nnz, triad_gbps,
            library, RAIL_SAMPLES, scale)
        del fb, fc, a, c, scale
    return {k: v["poisson5pt 1000x1000 f32"] for k, v in out.items()}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def counters():
    from cusp_autotuned_tpu_torch.autotune.calibrate import stream_triad
    from cusp_autotuned_tpu_torch.kernels.binned import binned_spmv
    from cusp_autotuned_tpu_torch.kernels.colsort import coo_spmv
    from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv
    from cusp_autotuned_tpu_torch.kernels.dia import dia_spmv
    return {"dia_spmv": dia_spmv, "csr_spmv": csr_spmv,
            "binned_spmv": binned_spmv, "coo_spmv": coo_spmv,
            "stream_triad": stream_triad}


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


def check_statuses(where, results):
    """Raise unless every result is Ok or a refused conversion."""
    from cusp_autotuned_tpu_torch.autotune import ResultStatus
    for r in results:
        if r.status not in (ResultStatus.Ok, ResultStatus.DeviceLimitsExceeded):
            raise RuntimeError(f"autotune: {r.configuration} on {where}: "
                               f"{r.status.value} {r.error}")


def walk(name, A, x):
    """tune() over the whole space with validation against the oracle.
    Every result must be Ok or a refused conversion: every plan takes the
    walk's 1-D x, so CompilationFailed on the card is a fault, and a kernel
    that does not build or launch raises out of tune()."""
    from cusp_autotuned_tpu_torch import autotune
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    t0 = time.perf_counter()
    results = autotune.tune(A, x, reference_computation=reference_spmv)
    log(f"autotune: tune({name}, {A.format}): {len(results)} configurations "
        f"in {time.perf_counter() - t0:.1f} s")
    for r in results:
        log(f"    {r.status.value:20s} {r.duration_ms:9.4f} ms  "
            f"{json.dumps(r.configuration, sort_keys=True)}"
            + (f"  ({r.error[:80]})" if r.error else ""))
    check_statuses(name, results)
    valid = {r.configuration["impl"] for r in results if r.is_valid()}
    if not {"binned", "colsort", "cuda"} <= valid:
        raise RuntimeError(f"autotune: {name}: binned, colsort and cuda must "
                           f"each validate; valid impls {sorted(valid)}")
    best = autotune.get_tuner().best_configuration(A, x)
    best_ms = min(r.duration_ms for r in results if r.is_valid())
    log(f"  winner: {best} at {best_ms:.4f} ms")
    # the tuner's channel times graph replays, the device's time; the
    # profiler's device time of the leading configurations checks it
    for r in sorted((r for r in results if r.is_valid()),
                    key=lambda r: r.duration_ms)[:4]:
        fn = build_spmv(A, r.configuration)
        log(f"    leader {r.duration_ms:.4f} ms tuned, "
            f"{device_ms(lambda: fn(x)):.4f} ms device: {r.configuration}")
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
                    for k, v in per_it.items()))

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
    for name in ("uniform random 1M x 1M", "power-law 1M rows"):
        del matrices[name]

    cg_launches, b, viadia_its = cg_phase(
        device, matrices["poisson5pt 1000x1000 f32"])
    tuned_launches, _ = autotune_phase(device, matrices, b, viadia_its)
    log(f"launches: cg.cu path {cg_launches}; autotune path {tuned_launches}")
    missing = [k for k in KERNELS if tuned_launches[k] < 1] + \
        [k for k in ("dia_spmv", "csr_spmv") if cg_launches[k] < 1]
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
    }
    kernels = []
    for name in KERNELS:
        r = records[name]
        bound_ms, bound_by = bound(r["bytes"], r["flops"])
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cusp_autotuned_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": cg_launches[name] + tuned_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
