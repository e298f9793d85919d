"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one GPU

The main path is the reference's cg.cu configuration: poisson5pt 1000x1000
(1,000,000 unknowns), a via_dia planned operator, CG under a Monitor at
rel-tol 1e-5 with at most 2000 iterations, then the true residual
b - A x through the default CSR operator.  Phases:

  build     nvcc builds the kernels from cusp_autotuned_tpu_torch/csrc/
  dia_spmv  the DIA kernel against its plain PyTorch version on the card,
            at the main path's shape (f32 and bf16 storage) and at the JAX
            package's DIA test shapes, timed with CUDA events (per call)
            and torch.profiler (device time)
  csr_spmv  the CSR kernel against its plain version: poisson5pt 1000x1000
            and a seeded 1M-row matrix with skewed row lengths
  cg        the main path, with every kernel's launch count set to 0 just
            before it and read just after; then a 100x100 solve through the
            kernel operator against one through the plain operator

Any failed check raises, and the script exits non-zero.  It exits non-zero
at once where torch sees no CUDA device.  Its last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}.
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
SAMPLES, PER_SAMPLE = 25, 20         # timed samples per version and turn,
                                     # back-to-back launches per sample


def log(*args):
    print(*args, flush=True)


def median_ms(fn):
    """Median over SAMPLES of the per-launch CUDA-event time of PER_SAMPLE
    back-to-back launches, after a warm-up.  Events around a single launch
    would also count the host's launch gap while the device waits."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
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


def compare(name, kernel, plain, rtol, atol, useful_bytes):
    """Check kernel() against plain(), time both in turns (plain, kernel,
    kernel, plain) and take each one's device time.  Returns (max_abs_err,
    kernel_ms, plain_ms)."""
    y, yp = kernel(), plain()
    torch.cuda.synchronize()
    if y.shape != yp.shape or not torch.isfinite(y).all():
        raise RuntimeError(f"{name}: kernel output {tuple(y.shape)} is not "
                           f"finite or not of shape {tuple(yp.shape)}")
    err = float((y - yp).abs().max())
    if not torch.allclose(y, yp, rtol=rtol, atol=atol):
        raise RuntimeError(f"{name}: kernel differs from plain version, "
                           f"max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    p1, k1, k2, p2 = (median_ms(f) for f in (plain, kernel, kernel, plain))
    ms, plain_ms = statistics.median([k1, k2]), statistics.median([p1, p2])

    def device(fn):
        t = device_ms(fn)
        return (f"{t:.4f} ms device ({useful_bytes / t / 1e6:.1f} GB/s useful)"
                if t > 0 else "device time not measured")

    log(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms/call, "
        f"{device(kernel)}  plain {plain_ms:.4f} ms/call, {device(plain)}")
    return err, ms, plain_ms


def seeded_x(n, seed, device):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    return torch.from_numpy(x).to(device)


def dia_phase(device):
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
            DIA_RTOL, DIA_ATOL, useful)
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


def csr_phase(device):
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.kernels.csr import build_csr, csr_spmv_plain

    log("csr_spmv: kernel vs plain on the card, rtol 1e-4 atol 1e-4; useful "
        "bytes = nnz*(sizeof(val)+4) + (m+1)*4 + (n+m)*4")
    results = {}
    for name, A in [
            ("poisson5pt 1000x1000 f32",
             gallery.poisson5pt(1000, 1000, format="csr", device=device)),
            ("random 1M rows, skewed", skewed_csr(1_000_000, 2, device))]:
        fn = build_csr(A, {})
        a = fn.planned_arrays
        x = seeded_x(A.num_cols, 4, device)
        useful = A.nnz * (a["val"].element_size() + 4) + (2 * A.num_rows + 1
                                                          + A.num_cols) * 4
        log(f"  {name}: nnz {A.nnz}, longest row "
            f"{int((a['indptr'][1:] - a['indptr'][:-1]).max())}")
        results[name] = compare(
            name, lambda: fn(x),
            lambda: csr_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows),
            CSR_RTOL, CSR_ATOL, useful)
    return results["poisson5pt 1000x1000 f32"]


def cgcu(A_csr, b):
    """The main path: plan the via_dia operator, solve, and take the true
    residual through the default CSR operator.  Returns (x, monitor,
    relative true residual, set-up s, solve s)."""
    from cusp_autotuned_tpu_torch import solvers
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops import blas
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

    t0 = time.perf_counter()
    op = planned_operator(A_csr, {"impl": "via_dia"})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x, mon = solvers.cg(op, b, monitor=Monitor(b, 2000, 1e-5))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    r = b - planned_operator(A_csr)(x)
    return x, mon, float(blas.nrm2(r) / blas.nrm2(b)), t1 - t0, t2 - t1


def cg_phase(device):
    from cusp_autotuned_tpu_torch import gallery, solvers
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv
    from cusp_autotuned_tpu_torch.kernels.dia import dia_spmv
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

    A = gallery.poisson5pt(1000, 1000, format="csr", device=device)
    n = A.num_rows
    b = torch.as_tensor(np.random.RandomState(0).rand(n), dtype=torch.float32,
                        device=device)
    cgcu(A, b)                                  # warm-up: allocator, cuBLAS
    dia_spmv.launches = csr_spmv.launches = 0
    x, mon, true_res, setup_s, solve_s = cgcu(A, b)
    launches = {"dia_spmv": dia_spmv.launches, "csr_spmv": csr_spmv.launches}
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
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch sees no CUDA device; the port's "
                 "kernels run only on a GPU")
    from cusp_autotuned_tpu_torch.kernels import _build
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True).stdout.strip())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    dia_err, dia_ms, dia_plain_ms = dia_phase(device)
    csr_err, csr_ms, csr_plain_ms = csr_phase(device)
    launches = cg_phase(device)

    def record(name, source, replaces, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    log(json.dumps({"kernels": [
        record("dia_spmv", "cusp_autotuned_tpu_torch/csrc/dia_spmv.cu",
               "cusp_autotuned_tpu/kernels/pallas_dia.py:393",
               dia_err, dia_ms, dia_plain_ms),
        record("csr_spmv", "cusp_autotuned_tpu_torch/csrc/csr_spmv.cu",
               "cusp_autotuned_tpu/kernels/pallas_csr.py:171",
               csr_err, csr_ms, csr_plain_ms),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
