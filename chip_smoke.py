"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Eight main paths, each driven with every kernel's launch count set to 0
just before it and read just after:

  cg.cu     the reference's cg.cu configuration: poisson5pt 1000x1000
            (1,000,000 unknowns), a via_dia planned operator, CG under a
            Monitor at rel-tol 1e-5 with at most 2000 iterations, then the
            true residual b - A x through the default CSR operator;
  amg       smoothed-aggregation AMG-CG, the JAX package's
            benchmarks/amg_endtoend.py in the port's idiom: calibrate() (the
            cost model's rates, the take probe's among them),
            gallery.poisson5pt(1000, 1000) CSR f32,
            precond.smoothed_aggregation(A, spmv_config={}) with the cost
            model's pick for every level's A, R and P, one V-cycle timed,
            autotune.tuned_operator(A) with no walk (the model's pick), and
            CG under a Monitor at rel-tol 1e-5 with at most 2000 iterations,
            its true residual through the CSR kernel and its iterations
            against plain CG's; then smoothed_aggregation(A) with its
            defaults on poisson5pt 150x150 f64 (rel-tol 1e-10, the JAX
            package's iteration count), and an unstructured hierarchy,
            poisson7pt 100x100x100 f32 with spmv_config={};
  autotune  the tuner's path: calibrate() (the stream triad, the
            gather/segment-sum probes and the take probe), the exhaustive
            validated walk
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
            analytic eigenvalue and against the plain operator;
  multidevice
            the multi-device path on parallel.make_row_mesh([cuda:0] * 4),
            four mesh entries on the one card: cg.cu through the banded
            via_dia plan (shard_planned_dia, the DIA band kernels), its
            block apply at k = 16, distributed_cg, distributed_cg_shardmap
            and distributed_cg_halo (25 iterations on DIA) and
            distributed_bicgstab (CSR), cg(A_csr, b, mesh=) against the
            unsharded CSR-kernel solve, the row-banded binned and COO
            SpMVs on the skewed 1M-row matrix and distributed_cg_binned,
            AMG-CG with the amg path's hierarchy distributed
            (distribute_multilevel), shard_planned_blocks on routed
            (williams_suite(2.0)'s Economics made symmetric and diagonally
            dominant, CG against the single-device routed solve) and
            colsort2 (the power-law 1M-row matrix), lanczos(mesh=) and
            tuned_operator(A, mesh=), and the sharded SpMV and CG iteration
            timed against the unsharded ones;
  suite     the scattered-pattern rails on the Williams/Bell-Garland suite:
            gallery.williams_suite(scale=2.0)'s five scattered entries
            (Economics, FEM/Accelerator, Circuit, Webbase, LP) as CSR on the
            card, the validated vector walk (tune) on each with its leader
            and the best colsort2, routed, binned and colsort configurations
            in device ms, tuned_operator(A) applied once against the plain
            product, and a k = 16 block walk and tuned_operator(A, X) on
            Economics;
  probes    the measurement path's probes: benchmarks.dia_probe.main()
            (poisson5pt 1000x1000 f32, four modes at four block sizes and
            build_dia in f32 and bf16), benchmarks.dia_spmm_probe.main()
            (poisson5pt 1000x1000 at k = 16 and 128, 300x300 at k = 128,
            six modes, the plain version and cuSPARSE), and
            benchmarks.routed_probe.main() on williams_suite(2.0)'s
            Economics and LP (five modes on two plans, build_routed in f32
            and bf16), then harness.launch_floor_s() (a launch's cost back
            to back and in a CUDA graph, and the host's share);
  bench     cusp_autotuned_tpu_torch.bench.main(budget_s=BENCH_BUDGET_S)
            in this process: its one JSON line (the DIA headline against
            the triad, the cg.cu and AMG-CG rows, the rails' rates).

Phases:

  build        nvcc builds the kernels from cusp_autotuned_tpu_torch/csrc/
  triad        the stream triad kernel against its plain version, and the
               card's triad GB/s, the denominator of every bound below
  dia_spmv     the DIA kernel against its plain PyTorch version on the
               card, at the main path's shape (f32 and bf16 storage) and at
               the JAX package's DIA test shapes
  csr_spmv     the nnz-balanced CSR kernel against its plain version:
               poisson5pt 1000x1000, a seeded 1M-row matrix with skewed row
               lengths and williams_suite(2.0)'s LP, two calls bitwise
               equal; each also L2-cold (harness.time_cold) beside
               cuSPARSE and the bound (queue row 4)
  binned_spmv, coo_spmv
               the row-binned and the nnz-balanced COO kernels against
               their plain versions on four matrices: poisson5pt 1000x1000,
               the skewed 1M-row matrix, a uniform random 1M x 1M matrix
               (~8 entries a row) and a power-law 1M-row matrix; the COO
               kernel on poisson also L2-cold beside cuSPARSE (row 6)
  dia_spmm     the DIA SpMM kernel against its plain version: poisson5pt
               1000x1000 at k = 3, 16 and 128 in f32 and bf16 storage, and
               the JAX package's DIA SpMM test shapes
  binned_spmm, coo_spmm
               the row-binned and COO SpMM kernels against their plain
               versions at k = 16 on the four matrices above, and on the JAX
               package's SpMM test shapes
  colsort2_spmv, routed_spmv
               the colsort2 and routed kernels (with the colsort2 hub pair
               as routed's tail) against their plain versions on the four
               matrices above, on the JAX package's colsort2 and routed
               test shapes and on the row walk's edges (rows of 32 and 33
               entries and of thr and thr + 1, runs of empty rows, LP's
               2,000 rows of ~1,300 entries, rows that read x's end), two
               calls equal bit for bit; then both L2-cold beside cuSPARSE on
               poisson5pt 1000x1000, the skewed 1M-row matrix and LP, on the
               phase's plans and the default ones (rows 7 and 8)
  colsort2_spmm, routed_spmm
               the same at k = 16 on the four matrices, and on the JAX
               package's SpMM test shapes of the two rails
  dia_band_spmv, dia_band_spmm
               the DIA band kernels against their plain versions on every
               row band of poisson5pt 1000x1000 f32 over a mesh of four
               entries, a vector and k = 16, rtol 1e-6, and the banded
               product against the unsharded DIA kernel's
  launch_floor, dia_probe, dia_spmm_probe, routed_probe
               the measurement path's four kernels in every mode against
               their plain versions (the launch floor bit for bit; DIA at
               rtol 1e-5, atol 1e-4; routed at the rails' 1e-4 of each
               row's sum of |a x|), and each probe's shipped mode against
               the shipped kernel bit for bit (dia_probe full and nobounds
               against dia_spmv at four block sizes; dia_spmm_probe
               shipped, team=T and xtile against dia_spmm on every shape
               its main() times, poisson5pt 1000x1000 at k = 16 and 128
               and 300x300 at k = 128, and on 1000x1000 at k = 3;
               routed_probe full against routed_spmv on
               Economics and LP, two plans each), then the probes path
  take_probe   the take probe (both instantiations: x staged in shared
               memory, x read through L1/L2) against its plain version at
               64 tiles and 2, 3 and 18 passes, rtol 1e-6, then timed at
               4096 tiles and 18 passes, and the two-point tile_take_ns
  cg           the cg.cu path; then a 100x100 solve through the kernel
               operator against one through the plain operator
  amg          the amg path
  autotune     the autotune path
  spmm         the spmm path
  suite        the suite path
  multidevice  the multidevice path
  bench        the bench path
  model        for each matrix the autotune and suite paths walk, the cost
               model's pick (recommend_config) against the walk's leader,
               both timed again side by side as the tuner times them

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
SUITE_KERNELS = ("colsort2_spmv", "routed_spmv", "colsort2_spmm", "routed_spmm")
BAND_KERNELS = ("dia_band_spmv", "dia_band_spmm")
PROBE_KERNELS = ("launch_floor", "dia_probe", "dia_spmm_probe", "routed_probe")
KERNELS = (SPMV_KERNELS + SPMM_KERNELS + SUITE_KERNELS + ("take_probe",)
           + BAND_KERNELS + PROBE_KERNELS)
# the kernels the multidevice path must launch
MULTIDEVICE_KERNELS = BAND_KERNELS + ("csr_spmv", "binned_spmv", "coo_spmv",
                                      "colsort2_spmv", "routed_spmv")
MESH_ENTRIES = 4
BAND_RTOL = 1e-6                     # a band's rows are the unsharded kernel's
SHARDED_CG_RTOL = 1e-4               # __graft_entry__.py:99 (x of the CG variants)
ROW12_RTOL = 1e-5                    # relative to ||y||
# the kernels each wrapper launches, each once a call (the CSR fold where
# the plan has two tiles or more; the COO SpMM wrapper's torch.zeros adds a
# fill kernel, which is PyTorch's own, and so does the COO SpMV wrapper's
# for a plan with a run of more than GAP_ROWS empty rows)
WRAPPER_KERNELS = {
    "dia_spmv": ("dia_spmv_kernel",),
    "csr_spmv": ("csr_tile_kernel", "csr_fold_kernel"),
    "binned_spmv": ("binned_spmv_kernel",),
    "coo_spmv": ("coo_chunk_kernel", "coo_fold_kernel"),
    "stream_triad": ("stream_triad_kernel",), "dia_spmm": ("dia_spmm_kernel",),
    "binned_spmm": ("binned_spmm_kernel",),
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
# the phases' plans of the two new rails: two planes of 8 entries (rows
# above 16 entries in the hub region), and 4096-column windows
COLSORT2_CONFIG = {"vrow_planes": 2, "vrow_len": 8, "block_size": 256}
ROUTED_CONFIG = {"window": 4096, "block_size": 256}
SUITE_SCALE = 2.0
TAKE_RTOL = 1e-6                     # tests/test_calibrate.py:117
JAX_AMG_150_ITERATIONS = 20          # the JAX package's AMG-CG count at 150x150
                                     # (bench.py's amg_cg_iters configuration;
                                     # tests/test_torch_amg.py holds the port
                                     # to it on the CPU)
MODEL_RATIO = 1.25                   # the model's pick against the walk leader
MODEL_LINES = []                     # (matrix, pick, pick ms, leader, leader ms)
EARLIER_VIA_DIA_MS = "0.36-0.70"     # PERF.md §5, H100 80GB HBM3, 700 W
BENCH_BUDGET_S = 60.0                # the bench path's sweep


def log(*args):
    print(*args, flush=True)


def median_ms(fn, samples=SAMPLES, per_sample=PER_SAMPLE):
    """Milliseconds a call of fn(): the harness's timer (the median over
    `samples` of the CUDA-event time of `per_sample` back-to-back calls)."""
    from cusp_autotuned_tpu_torch.benchmarks.harness import time_fn
    return time_fn(fn, samples=samples, per_sample=per_sample) * 1e3


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
    for _ in range(3):              # a window with no device record at all
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


def check_mode(name, y, y_plain, rtol, atol, scale=None):
    """|y - y_plain| <= atol + rtol * scale (|y_plain| unless given), y
    finite and of y_plain's shape; returns the max abs error."""
    torch.cuda.synchronize()
    if y.shape != y_plain.shape or not torch.isfinite(y).all():
        raise RuntimeError(f"{name}: kernel output {tuple(y.shape)} is not finite "
                           f"or not of shape {tuple(y_plain.shape)}")
    diff = (y - y_plain).abs()
    bar = atol + rtol * (y_plain.abs() if scale is None else scale)
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= bar).all()):
        raise RuntimeError(f"{name}: kernel differs from plain version, max abs "
                           f"err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def compare(name, kernel, plain, rtol, atol, useful_bytes, flops, triad_gbps,
            library=None, samples=SAMPLES, scale=None, per_sample=PER_SAMPLE):
    """Check kernel() against plain(), time both in turns (plain, kernel,
    kernel, plain), and library() beside them.  Returns the line's numbers.
    The check is |y - y_plain| <= atol + rtol * scale, where scale is
    |y_plain| unless given (the rails give each row's sum of |a_ij x_j|)."""
    err = check_mode(name, kernel(), plain(), rtol, atol, scale)
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


def cold_line(label, fn, x, nbytes, library=None):
    """Print fn's and the library call's L2-cold times (spmv_tiles.cold and
    library_cold, through harness.time_cold: device ms from a graph's
    replay, ms a call back to back), beside the bound at the data-sheet
    rate.  fn is a plan (planned_arrays, apply), so that each copy holds
    arrays of its own; library is a sparse CSR tensor."""
    from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
    dev, call = spmv_tiles.cold(fn, x, nbytes, samples=RAIL_SAMPLES)
    line = (f"  {label}, L2-cold: {dev:.4f} ms device, {call:.4f} "
            f"ms a call; bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    if library is not None:
        ldev, lcall = spmv_tiles.library_cold(library, x, nbytes,
                                              samples=RAIL_SAMPLES)
        line += f"; cuSPARSE {ldev:.4f} ms device, {lcall:.4f} ms a call"
    log(line)


def lp_csr(device):
    """williams_suite(SUITE_SCALE)'s LP: 2,000 rows of ~1,300 entries."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    S = gallery.williams_suite(SUITE_SCALE, names=("LP",))["LP"]
    return from_scipy(S, "csr", dtype=torch.float32, device=device)


def csr_phase(device, triad_gbps, matrices):
    from cusp_autotuned_tpu_torch.kernels.csr import build_csr, csr_spmv_plain

    log("csr_spmv (row 4): the nnz-balanced tile kernel vs plain on the card, "
        "atol 1e-4 plus rtol 1e-4 of each row's sum of |a_ij x_j| (the tile "
        "carries change the order of summation); useful bytes = "
        "nnz*(sizeof(val)+4) + (m+1)*4 + (n+m)*4")
    results = {}
    cases = [(name, matrices[name]) for name in ("poisson5pt 1000x1000 f32",
                                                 "random 1M rows, skewed")]
    cases.append(("Williams LP (suite 2.0)", lp_csr(device)))
    for name, A in cases:
        fn = build_csr(A, {})
        a = fn.planned_arrays
        x = seeded_x(A.num_cols, 4, device)
        useful = A.nnz * (a["val"].element_size() + 4) + (2 * A.num_rows + 1
                                                          + A.num_cols) * 4
        describe(name, A)
        scale = csr_spmv_plain(a["row"], a["col"], a["val"].abs().double(),
                               x.abs().double(), A.num_rows).float()
        S = sparse_csr(A)
        results[name] = compare(
            name, lambda: fn(x),
            lambda: csr_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows),
            RAIL_RTOL, RAIL_ATOL, useful, 2 * A.nnz, triad_gbps,
            library_spmv(A, x, S), scale=scale)
        first, second = fn(x), fn(x)
        if not torch.equal(first, second):
            raise RuntimeError(f"csr_spmv {name}: two calls differ")
        cold_line(f"row 4: csr {name} ({fn.plan_stats['tiles']} tiles of "
                  f"{fn.plan_stats['tile']})", fn, x, useful, S)
        del fn, a, scale, S
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
        if name == "poisson5pt 1000x1000 f32":
            if not torch.equal(fc(x), fc(x)):
                raise RuntimeError("coo_spmv: two calls differ")
            cold_line(f"row 6: coo {name}", fc, x, nnz * 12 + (n + m) * 4,
                      sparse_csr(A))
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


def random_csr(m, n, density, seed, device, eye=False):
    """A seeded m x n CSR matrix of m * n * density uniform draws
    (duplicates merged), plus the identity where asked: the shapes and
    densities of the JAX package's rail tests, drawn by index (scipy's
    sparse.random walks every cell, minutes at 1e9 cells on some hosts)."""
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    nnz = int(round(m * n * density))
    S = sp.coo_matrix((rng.uniform(-1.0, 1.0, nnz),
                       (rng.randint(0, m, nnz), rng.randint(0, n, nnz))), shape=(m, n))
    if eye:
        S = S + sp.eye(m, n)
    return from_scipy(S.tocsr(), "csr", dtype=torch.float32, device=device)


def hub_row_csr(device):
    """tests/test_pallas.py:835's shape: 3000 x 3000 at density 8e-4 plus a
    400-entry row 7."""
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
    import scipy.sparse as sp
    rng = np.random.RandomState(3)
    hub = sp.coo_matrix((rng.randn(400), (np.full(400, 7),
                                          rng.choice(3000, 400, replace=False))),
                        shape=(3000, 3000))
    S = to_scipy(random_csr(3000, 3000, 8e-4, 3, "cpu")) + hub
    return from_scipy(S.tocsr(), "csr", dtype=torch.float32, device=device)


def routed_hub_cap(A):
    """(hub_cap, tail share): 0 (the default, max(64, 4 nnz / m)) where the
    routed plan's tail holds at most half the entries, else the least power
    of two above it that brings the tail to half or less, so that a
    tail-dominant matrix still reaches the routed kernel."""
    from cusp_autotuned_tpu_torch.kernels.colsort2 import auto_hub_cap
    lengths = torch.diff(A.indptr).cpu().numpy().astype(np.int64)
    nnz = int(lengths.sum())

    def tail(cap):
        return float(lengths[lengths > cap].sum()) / max(nnz, 1)

    cap = auto_hub_cap(nnz, A.num_rows)
    if tail(cap) <= 0.5:
        return 0, tail(cap)
    cap = 1 << int(cap).bit_length()
    while tail(cap) > 0.5:
        cap <<= 1
    return cap, tail(cap)


def plain_product(A, X):
    """(A @ X, each row's sum of |a_ij X_j|) through the plain CSR path, for a
    vector or a block."""
    from cusp_autotuned_tpu_torch.kernels.csr import csr_spmv_plain
    Y = csr_spmv_plain(A.row, A.col, A.val, X, A.num_rows)
    scale = csr_spmv_plain(A.row, A.col, A.val.abs().double(), X.abs().double(),
                           A.num_rows).float()
    return Y, scale


def edge_csr(lengths, n, seed, device, tail_cols=0):
    """A seeded CSR matrix with the given row lengths and n columns, drawn
    by index (repeats in a row merged); with tail_cols, every column lies
    in the last tail_cols of x."""
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    lo = n - tail_cols if tail_cols else 0
    cols = rng.randint(lo, n, rows.size)
    S = sp.coo_matrix((rng.uniform(-1.0, 1.0, rows.size), (rows, cols)),
                      shape=(lengths.size, n))
    return from_scipy(S.tocsr(), "csr", dtype=torch.float32, device=device)


def new_rails_phase(device, triad_gbps, matrices):
    """The colsort2 and routed kernels against their plain versions, SpMV
    and SpMM, then their L2-cold lines; returns each kernel's record on
    poisson5pt 1000x1000."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.kernels.colsort2 import (
        build_colsort2, colsort2_spmv_plain)
    from cusp_autotuned_tpu_torch.kernels.routed import (
        build_routed, routed_spmv_plain)
    from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException

    log(f"colsort2_spmv / routed_spmv / colsort2_spmm / routed_spmm: kernels vs "
        f"plain on the card, atol 1e-4 plus rtol 1e-4 of each (row, column)'s sum "
        f"of |a_ij x_j|; plans colsort2 {COLSORT2_CONFIG}, routed {ROUTED_CONFIG} "
        f"unless the line says otherwise (routed's tail through the colsort2 hub "
        f"pair); useful bytes, the matrix as CSR once and x and y once: "
        f"nnz*(4+4) + (m+1)*4 + (n+m)*k*4")
    big = list(matrices.items())
    cases = [(name, A, {}, {}, 0) for name, A in big]
    cases += [  # tests/test_pallas.py:541, :546, :559, :576, :827, :835, :925
        ("poisson9pt 35x35", gallery.poisson9pt(35, 35, format="csr", device=device),
         {}, {}, 0),
        ("power-law 800 rows hub_cap 8", powerlaw_csr(800, 8000, 3, device),
         {"hub_cap": 8}, {}, 0),
        ("random 700x700 +I K=1", random_csr(700, 700, 0.02, 11, device, True),
         {"vrow_planes": 1}, {}, 0),
        ("random 700x700 +I K=4", random_csr(700, 700, 0.02, 11, device, True),
         {"vrow_planes": 4}, {}, 0),
        ("rect 300x900", random_csr(300, 900, 0.02, 13, device), {}, {}, 0),
        ("rect 900x300", random_csr(900, 300, 0.02, 14, device), {}, {}, 0),
        ("random scatter 4000x4000 +I", random_csr(4000, 4000, 6e-4, 11, device, True),
         {}, {}, 0),
        ("hub row 3000x3000 hub_cap 32", hub_row_csr(device), {}, {"hub_cap": 32}, 0),
        ("rect 3000x5000", random_csr(3000, 5000, 5e-4, 9, device), {}, {}, 0),
    ]
    # the row walk's edges (csrc/rail_rows.cuh): rows of 32 and 33 entries
    # (a lane or a warp) and of thr and thr + 1 (main or hub), runs of
    # empty rows, LP's rows of ~1,300 entries (a warp each under the default
    # plans), and rows that read x's last columns
    edges = edge_csr([16, 17, 32, 33, 64, 65, 5, 0] * 700, 20000, 21, device)
    gaps = edge_csr([0] * 40 + ([3, 0, 33] + [0] * 100 + [7] * 40 + [0] * 1000)
                    * 30 + [0] * 70, 5000, 22, device)
    lp = lp_csr(device)
    cases += [
        ("edges 16/17/32/33/64/65, thr 16", edges, {}, {"hub_cap": 64}, 0),
        ("edges 16/17/32/33/64/65, thr 64", edges,
         {"vrow_len": 32, "hub_cap": 64}, {"hub_cap": 64}, 0),
        ("runs of 40 to 1000 empty rows", gaps, {"vrow_len": 32, "hub_cap": 64},
         {}, 0),
        ("Williams LP (suite 2.0), default plans", lp, {"vrow_len": 0}, {"window": 0},
         0),
        ("rows that read x's end (n 4998)", edge_csr([16] * 4096, 4998, 23, device,
                                                     tail_cols=300), {}, {}, 0),
    ]
    cases += [(f"{name} k=16", A, {}, {}, 16) for name, A in big]
    cases += [  # tests/test_pallas.py:743, :756, :925
        ("rect 500x700 k=10", random_csr(500, 700, 0.02, 17, device), {}, {}, 10),
        ("power-law 600 rows hub_cap 8 k=6", powerlaw_csr(600, 6000, 9, device),
         {"hub_cap": 8}, {}, 6),
        ("rect 3000x5000 k=5", random_csr(3000, 5000, 5e-4, 9, device), {}, {}, 5),
        ("power-law 800 rows hub_cap 8 k=3", powerlaw_csr(800, 8000, 3, device),
         {"hub_cap": 8}, {}, 3),
    ]
    out = {k: {} for k in SUITE_KERNELS}
    for name, A, c2cfg, rcfg, k in cases:
        X = seeded_x(A.num_cols, 5, device) if k == 0 else \
            seeded_block(A.num_cols, k, 5, device)
        m, n, nnz = A.num_rows, A.num_cols, A.nnz
        many = m >= 1_000_000
        samples, per_sample = ((RAIL_SAMPLES if many else SAMPLES), PER_SAMPLE) \
            if k == 0 else (SPMM_SAMPLES, SPMM_PER_SAMPLE)
        _, scale = plain_product(A, X)
        library = library_spmv(A, X)
        useful = nnz * 8 + (m + 1) * 4 + (n + m) * max(k, 1) * 4
        flops = 2 * nnz * max(k, 1)
        kind = "spmv" if k == 0 else "spmm"
        if k == 0:
            describe(name, A)

        fc = build_colsort2(A, {**COLSORT2_CONFIG, **c2cfg})
        a, st = fc.planned_arrays, fc.plan_stats
        out[f"colsort2_{kind}"][name] = compare(
            f"colsort2 {name} (thr {st['thr']}, {st['long_rows']} long rows, "
            f"{st['hub_rows']} hub rows in {st['hub_vrows']} virtual rows)",
            lambda: fc(X),
            lambda: colsort2_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"], X,
                                        m, st["vrow_planes"], st["vrow_len"], st["thr"]),
            RAIL_RTOL, RAIL_ATOL, useful, flops, triad_gbps, library, samples, scale,
            per_sample)
        if k == 0 and not torch.equal(fc(X), fc(X)):
            raise RuntimeError(f"colsort2_spmv {name}: two calls differ")
        del fc, a

        cap, share = routed_hub_cap(A)
        if cap and "hub_cap" not in rcfg:
            try:
                build_routed(A, {**ROUTED_CONFIG, **rcfg})
                raise RuntimeError(f"routed: {name} planned a tail of {share:.3f}")
            except FormatConversionException as e:
                log(f"    routed refuses the default hub_cap: {str(e)[:100]}; the "
                    f"line runs hub_cap {cap} (tail {100 * share:.1f} %)")
            rcfg = {**rcfg, "hub_cap": cap}
        fr = build_routed(A, {**ROUTED_CONFIG, **rcfg})
        r, st = fr.planned_arrays, fr.plan_stats
        out[f"routed_{kind}"][name] = compare(
            f"routed {name} (hub_cap {st['hub_cap']}, tail {st['tail']}, "
            f"{st['long_rows']} long rows, {st['staged_spmm_windows']} staged "
            f"SpMM windows)", lambda: fr(X),
            lambda: routed_spmv_plain(r["indptr"], r["col"], r["val"], r["hub"], X, m,
                                      st["hub_cap"]),
            RAIL_RTOL, RAIL_ATOL, useful, flops, triad_gbps, library, samples, scale,
            per_sample)
        if k == 0 and not torch.equal(fr(X), fr(X)):
            raise RuntimeError(f"routed_spmv {name}: two calls differ")
        del fr, r, scale, library, X

    # tests/test_pallas.py:942: both rails' packages refuse routed here
    tail_dominant = powerlaw_csr(3000, 15000, 1, device)
    try:
        build_routed(tail_dominant, {})
        raise RuntimeError("routed planned the tail-dominant power-law 3000 rows")
    except FormatConversionException as e:
        log(f"  routed on power-law 3000 rows (tests/test_pallas.py:942): refused, "
            f"{str(e)[:120]}")

    log("rows 7 and 8, L2-cold (benchmarks/spmv_tiles.py's timing): useful "
        "bytes nnz*(4+4) + (m+1)*4 + (n+m)*4")
    for name, A in (("poisson5pt 1000x1000 f32", matrices["poisson5pt 1000x1000 f32"]),
                    ("random 1M rows, skewed", matrices["random 1M rows, skewed"]),
                    ("Williams LP (suite 2.0)", lp)):
        x = seeded_x(A.num_cols, 4, device)
        nbytes = A.nnz * 8 + (2 * A.num_rows + 1 + A.num_cols) * 4
        S = sparse_csr(A)
        for label, build, cfg in (("colsort2", build_colsort2, COLSORT2_CONFIG),
                                  ("colsort2", build_colsort2, {}),
                                  ("routed", build_routed, ROUTED_CONFIG),
                                  ("routed", build_routed, {})):
            fn = build(A, cfg)
            row = 7 if label == "colsort2" else 8
            cold_line(f"row {row}: {label} {cfg or 'default'} {name}", fn, x,
                      nbytes, S)
            S = None                  # cuSPARSE once a matrix
            del fn
        del x
    return {"colsort2_spmv": out["colsort2_spmv"]["poisson5pt 1000x1000 f32"],
            "routed_spmv": out["routed_spmv"]["poisson5pt 1000x1000 f32"],
            "colsort2_spmm": out["colsort2_spmm"]["poisson5pt 1000x1000 f32 k=16"],
            "routed_spmm": out["routed_spmm"]["poisson5pt 1000x1000 f32 k=16"]}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def counters():
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
    return launches, b, its, rel


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
    profiler's reading of each of their kernels.  Returns the results."""
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
    return results


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
        x = seeded_x(matrices[name].num_cols, 6, device)
        model_line(name, matrices[name], x, walk(name, matrices[name], x))

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


def check_block(name, Y, plain, scale, path="spmm"):
    """Y against the plain product at the kernels' bar."""
    torch.cuda.synchronize()
    if Y.shape != plain.shape or not torch.isfinite(Y).all():
        raise RuntimeError(f"{path}: {name}: output {tuple(Y.shape)} is not finite "
                           f"or not of shape {tuple(plain.shape)}")
    diff = (Y - plain).abs()
    if not bool((diff <= RAIL_ATOL + RAIL_RTOL * scale).all()):
        raise RuntimeError(f"{path}: {name} differs from the plain product by "
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
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops.multiply import multiply

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


RAILS = ("colsort2", "routed", "binned", "colsort")


def rail_bests(name, results):
    """Log the leader of a walk and the best configuration of each rail, in
    the tuner's device ms, or why the rail has none."""
    from cusp_autotuned_tpu_torch.autotune import ResultStatus
    valid = [r for r in results if r.is_valid()]
    lead = min(valid, key=lambda r: r.duration_ms)
    parts = []
    for impl in RAILS:
        mine = [r for r in results if r.configuration["impl"] == impl]
        ok = [r for r in mine if r.is_valid()]
        if ok:
            b = min(ok, key=lambda r: r.duration_ms)
            keys = {k: v for k, v in b.configuration.items()
                    if v not in (0, "none") and k not in ("impl", "dia_impl")}
            parts.append(f"{impl} {b.duration_ms:.4f} {keys}")
        else:
            why = {r.status.value for r in mine} | {
                (r.error or "")[:60] for r in mine
                if r.status == ResultStatus.DeviceLimitsExceeded}
            parts.append(f"{impl} none ({'; '.join(sorted(why))})")
    log(f"suite: {name}: leader {label(lead.configuration)} {lead.duration_ms:.4f} "
        f"ms {lead.configuration}; best device ms a call: " + "; ".join(parts))


def suite_phase(device):
    """The suite path; returns its launch counts."""
    from cusp_autotuned_tpu_torch import autotune, gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    from cusp_autotuned_tpu_torch.gallery.suite import SCATTERED

    t0 = time.perf_counter()
    suite = gallery.williams_suite(SUITE_SCALE, names=SCATTERED)
    mats = {name: from_scipy(S, "csr", dtype=torch.float32, device=device)
            for name, S in suite.items()}
    del suite
    log(f"suite: williams_suite({SUITE_SCALE}, names={SCATTERED}) on the card as "
        f"CSR f32 in {time.perf_counter() - t0:.1f} s:")
    for name, A in mats.items():
        describe(name, A)
        cap, share = routed_hub_cap(A)
        log(f"    routed's tail at the default hub_cap: {100 * share:.1f} % of the "
            f"entries" if not cap else f"    routed's tail at the default hub_cap "
            f"is above half the entries: its walk configurations are refused")
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()
    best = autotune.get_tuner().best_configuration
    for name, A in mats.items():
        x = seeded_x(A.num_cols, 13, device)
        results = walk(f"suite {name}", A, x, need=("colsort2", "binned", "colsort"))
        rail_bests(name, results)
        model_line(name, A, x, results)
        y_plain, scale = plain_product(A, x)
        err = check_block(f"tuned_operator({name})", autotune.tuned_operator(A, x)(x),
                          y_plain, scale, "suite")
        log(f"suite: tuned_operator({name}) runs {best(A, x)}: max abs err "
            f"{err:.3e} against the plain product")
        del y_plain, scale
    A = mats["Economics"]
    X = seeded_block(A.num_cols, 16, 14, device)
    rail_bests("Economics k=16", walk("suite Economics", A, X,
                                      need=("colsort2", "routed", "binned")))
    Y_plain, scale = plain_product(A, X)
    err = check_block("tuned_operator(Economics, X)", autotune.tuned_operator(A, X)(X),
                      Y_plain, scale, "suite")
    log(f"suite: tuned_operator(Economics, X (n, 16)) runs {best(A, X)}: max abs "
        f"err {err:.3e} against the plain product")
    launches = read_counts()
    log(f"suite: path in {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return launches


def shared_memory_tb_per_s():
    """The SMs' shared-memory rate at the card's top SM clock: 32 banks of
    4 bytes a clock on each of its SMs (the Hopper tuning guide's figure),
    in TB/s; None where nvidia-smi does not give the clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip()
    try:
        mhz = float(out.splitlines()[0])
    except (ValueError, IndexError):
        return None, out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6 / 1e12, f"{sms} SMs at {mhz:.0f} MHz"


def take_probe_phase(device, triad_gbps):
    """The take probe against its plain version, timed at full size; returns
    the kernel's record (the instantiation that stages x in shared memory,
    18 passes over 4096 tiles) and the two-point tile times."""
    from cusp_autotuned_tpu_torch.autotune import calibrate

    lane = calibrate.LANE
    idx = calibrate.take_probe_planes().to(device)
    rng = np.random.RandomState(0)
    x64 = torch.from_numpy(rng.randn(64 * lane, lane).astype(np.float32)).to(device)
    log(f"take_probe: kernel vs plain on the card at 64 tiles, rtol {TAKE_RTOL}: ")
    for from_shared in (True, False):
        for passes in (2, 3, 18):
            y = calibrate.take_probe(x64, idx, passes, from_shared)
            yp = calibrate.take_probe_plain(x64, idx, passes)
            torch.cuda.synchronize()
            err = float((y - yp).abs().max())
            ok = bool(((y - yp).abs() <= TAKE_RTOL * yp.abs()).all())
            log(f"  {'shared' if from_shared else 'global'} x, {passes} passes: "
                f"max abs err {err:.3e}")
            if not ok:
                raise RuntimeError(f"take_probe: kernel differs from plain version "
                                   f"at {passes} passes (max abs err {err:.3e})")
    tiles, passes = calibrate.TAKE_TILES, max(calibrate.TAKE_PASSES)
    x = torch.randn(tiles * lane, lane, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    n = x.numel()
    # bytes: x read once, the output written once, the planes read once;
    # operations: a product and a sum for each of passes * n gathers
    useful = 8 * n + passes * lane * lane * 4
    shared_tb, clock = shared_memory_tb_per_s()
    floor = (f"{passes * n * 4 / (shared_tb * 1e12) * 1e3:.4f} ms ({clock}, "
             f"{shared_tb:.1f} TB/s)" if shared_tb else f"not known ({clock})")
    log(f"take_probe: {tiles} tiles, {passes} passes; shared-memory gather floor "
        f"(passes x {n} x 4 B over the SMs' shared-memory rate): {floor}")
    records = {}
    for from_shared in (True, False):
        name = f"take_probe {'shared' if from_shared else 'global'} x"
        records[from_shared] = compare(
            name, lambda: calibrate.take_probe(x, idx, passes, from_shared),
            lambda: calibrate.take_probe_plain(x, idx, passes), TAKE_RTOL, 0.0,
            useful, 2 * passes * n, triad_gbps, samples=3, per_sample=3)
    ns = {k: calibrate.tile_take_ns(device, from_shared=k) for k in (True, False)}
    log(f"take_probe: tile_take_ns (two points, 2 and {passes} passes, {tiles} "
        f"tiles): shared x {ns[True]:.4f} ns, global x {ns[False]:.4f} ns a "
        f"(128, 128) tile pass = {1e3 * ns[True] / (lane * lane):.3f} and "
        f"{1e3 * ns[False] / (lane * lane):.3f} ps a gathered element")
    return records[True]


def model_line(name, A, x, results):
    """The cost model's pick for A against the leader of the walk `results`,
    both timed again side by side (pick, leader, leader, pick) as the tuner
    times a configuration; recorded in MODEL_LINES."""
    from cusp_autotuned_tpu_torch.autotune import Tuner
    from cusp_autotuned_tpu_torch.autotune.cost_model import predict, recommend_config
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    pick, us = recommend_config(A, x)
    lead = min((r for r in results if r.is_valid()), key=lambda r: r.duration_ms)
    fns = {"pick": build_spmv(A, pick), "leader": build_spmv(A, lead.configuration)}
    t = Tuner()
    times = {"pick": [], "leader": []}
    for k in ("pick", "leader", "leader", "pick"):
        times[k].append(t._time_graph(fns[k], x))
    pick_ms, lead_ms = (statistics.median(times[k]) for k in ("pick", "leader"))
    priced = {k: round(v["us"], 2) for k, v in predict(A, x).items() if "us" in v}
    MODEL_LINES.append((name, pick, pick_ms, lead.configuration, lead_ms))
    log(f"model: {name}: pick {pick} (predicted {us:.2f} us) {pick_ms:.4f} ms; "
        f"walk leader {label(lead.configuration)} {lead.duration_ms:.4f} ms in the "
        f"walk, {lead_ms:.4f} ms now; pick / leader {pick_ms / lead_ms:.3f}; "
        f"predicted us {priced}")


def launch_calls(fn, calls):
    """(device kernels, host kernel-launch calls) per call of fn, from
    torch.profiler: the device records (some may be dropped, PERF.md §7)
    and the runtime's launch calls on the host."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    device = host = 0
    device_ms = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep"):
            device += e.count
            device_ms += e.self_device_time_total / 1e3
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                       "cudaGraphLaunch"):
            host += e.count
    return device_ms / calls, device / calls, host / calls


def describe_levels(M):
    for i, lvl in enumerate(M.levels):
        log(f"    level {i}: {lvl.A.num_rows} rows, {lvl.A.num_entries} entries; "
            f"A {lvl.apply_op.impl if lvl.Aop is not None else 'container'}, "
            f"R {lvl.restrict_op.impl if lvl.Rop is not None else 'container'}, "
            f"P {lvl.prolong_op.impl if lvl.Pop is not None else 'container'}")
    log(f"    coarse: {M.coarse.n} rows (dense inverse); operator complexity "
        f"{M.operator_complexity():.3f}, grid complexity {M.grid_complexity():.3f}")


def amg_phase(device):
    """The amg path; returns its launch counts.  Its right-hand side is
    b = A x_true for a seeded x_true of entries in [0, 1): for the cg.cu
    path's b (entries in [0, 1)) the f32 solution is large, and its
    rounding alone keeps the true residual far above the bar of 1e-4 (the
    cg phase prints it), however well CG converges."""
    from cusp_autotuned_tpu_torch import autotune, gallery, solvers
    from cusp_autotuned_tpu_torch.autotune import calibrate
    from cusp_autotuned_tpu_torch.autotune.tuner import matrix_signature
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops import blas
    from cusp_autotuned_tpu_torch.precond import smoothed_aggregation
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

    A = gallery.poisson5pt(1000, 1000, format="csr", device=device)
    n = A.num_rows
    x_true = torch.as_tensor(np.random.RandomState(0).rand(n), dtype=torch.float32,
                             device=device)
    b = planned_operator(A, {"impl": "segsum"})(x_true)
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()
    consts = calibrate.calibrate(device)
    log(f"amg: calibrate() {consts}")
    t0 = time.perf_counter()
    M = smoothed_aggregation(A, spmv_config={})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"amg: smoothed_aggregation(poisson5pt 1000x1000 f32, spmv_config={{}}) "
        f"in {setup_s:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in
                                         M.setup_s.items()) + " s):")
    describe_levels(M)
    if M.levels[0].Aop is None or M.levels[0].Aop.impl != "via_dia":
        raise RuntimeError("amg: the fine level's A is not on the DIA kernel")
    v = M(b)
    if v.shape != b.shape or not torch.isfinite(v).all():
        raise RuntimeError("amg: the V-cycle's output is not finite or not of shape (n,)")
    cycle_ms = median_ms(lambda: M(b), samples=5, per_sample=10)
    cycle_dev, kernels, launches = launch_calls(lambda: M(b), 10)
    log(f"amg: one V-cycle {cycle_ms:.4f} ms a call (CUDA events, 10 back to "
        f"back), {cycle_dev:.4f} ms device ({100 * cycle_dev / cycle_ms:.1f} % "
        f"busy), {kernels:.1f} kernels recorded and {launches:.1f} launch calls a "
        f"cycle")
    if autotune.get_tuner().results.get(matrix_signature(A)):
        raise RuntimeError("amg: the tuner holds results for A; the pick below "
                           "would not be the model's")
    op = autotune.tuned_operator(A)
    log(f"amg: tuned_operator(A) with no walk: {autotune.get_tuner().best_configuration(A)}"
        f" ({op.impl})")
    solvers.cg(op, b, M=M, monitor=Monitor(b, 3, 1e-5))        # warm-up
    cycles = []

    def counted(r):                 # the V-cycles cg applies
        cycles.append(1)
        return M(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, mon = solvers.cg(op, b, M=counted, monitor=Monitor(b, 2000, 1e-5))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    its = mon.iteration_count()
    true_res = float(blas.nrm2(b - planned_operator(A)(x)) / blas.nrm2(b))
    err = float(blas.nrm2(x - x_true) / blas.nrm2(x_true))
    _, mon_plain, plain_s = solve(op, b)
    plain_its = mon_plain.iteration_count()
    log(f"amg: AMG-CG (rtol 1e-5, limit 2000): {its} iterations, converged "
        f"{mon.converged()}, relative residual "
        f"{mon.residual_norm() / mon.b_norm:.3e}, true {true_res:.3e} (CSR "
        f"kernel), error against x_true {err:.3e}; solve {solve_s:.3f} s, "
        f"{1e3 * solve_s / max(its, 1):.4f} ms/iteration, {len(cycles)} V-cycles "
        f"(cg reads its stop flag every iteration when M is set); plain CG on "
        f"the same b {plain_its} iterations, {plain_s:.3f} s, "
        f"{1e3 * plain_s / max(plain_its, 1):.4f} ms/iteration")
    if len(cycles) > its + 2:
        raise RuntimeError(f"amg: cg applied M {len(cycles)} times in {its} "
                           f"iterations")
    if not (mon.converged() and torch.isfinite(x).all() and true_res < 1e-4
            and its < plain_its / 2):
        raise RuntimeError(f"amg: AMG-CG took {its} iterations (plain CG "
                           f"{plain_its}), true residual {true_res}")
    del op, x

    # the defaults, as bench.py's amg_cg_iters row runs them
    A150 = gallery.poisson5pt(150, 150, format="csr", dtype=torch.float64,
                              device=device)
    b150 = torch.as_tensor(1.01 * np.random.RandomState(7).rand(A150.num_rows)
                           + 0.5, device=device)
    M150 = smoothed_aggregation(A150)
    x150, mon150 = solvers.cg(A150, b150, M=M150, monitor=Monitor(b150, 100, 1e-10))
    its150 = mon150.iteration_count()
    log(f"amg: poisson5pt 150x150 f64, smoothed_aggregation(A) defaults, rtol "
        f"1e-10: {its150} iterations (the JAX package: {JAX_AMG_150_ITERATIONS}), "
        f"converged {mon150.converged()}")
    if its150 != JAX_AMG_150_ITERATIONS or not mon150.converged():
        raise RuntimeError(f"amg: the 150x150 solve took {its150} iterations, "
                           f"not {JAX_AMG_150_ITERATIONS}")

    # an unstructured hierarchy: 3-D, so no raster grid, standard aggregation
    A7 = gallery.poisson7pt(100, 100, 100, format="csr", device=device)
    x7_true = torch.as_tensor(np.random.RandomState(1).rand(A7.num_rows),
                              dtype=torch.float32, device=device)
    b7 = planned_operator(A7, {"impl": "segsum"})(x7_true)
    t0 = time.perf_counter()
    M7 = smoothed_aggregation(A7, spmv_config={})
    torch.cuda.synchronize()
    log(f"amg: smoothed_aggregation(poisson7pt 100x100x100 f32, spmv_config={{}}) "
        f"in {time.perf_counter() - t0:.2f} s (" + ", ".join(
            f"{k} {v:.2f}" for k, v in M7.setup_s.items()) + " s):")
    describe_levels(M7)
    op7 = autotune.tuned_operator(A7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x7, mon7 = solvers.cg(op7, b7, M=M7, monitor=Monitor(b7, 2000, 1e-5))
    torch.cuda.synchronize()
    solve7 = time.perf_counter() - t0
    its7 = mon7.iteration_count()
    true7 = float(blas.nrm2(b7 - planned_operator(A7)(x7)) / blas.nrm2(b7))
    log(f"amg: poisson7pt AMG-CG through {op7.impl}: {its7} iterations, converged "
        f"{mon7.converged()}, true relative residual {true7:.3e}, "
        f"{1e3 * solve7 / max(its7, 1):.4f} ms/iteration")
    if not (mon7.converged() and true7 < 1e-4):
        raise RuntimeError("amg: the poisson7pt AMG-CG did not converge")
    launches = read_counts()
    log(f"amg: path in {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return launches, its, M, b


def band_csr(A, r0, r1):
    """Rows [r0, r1) of a CSR container as a torch.sparse_csr_tensor, the
    cuSPARSE yardstick of one band."""
    lo, hi = int(A.indptr[r0]), int(A.indptr[r1])
    return torch.sparse_csr_tensor(A.indptr[r0:r1 + 1] - lo, A.col[lo:hi],
                                   A.val[lo:hi].float(), size=(r1 - r0, A.num_cols))


def band_phase(device, triad_gbps, A_csr, S):
    """The DIA band kernels against their plain versions on every band of
    poisson5pt 1000x1000 over a mesh of MESH_ENTRIES entries on the card,
    a vector and k = 16, and the banded product against the unsharded DIA
    kernel's; band 0 timed.  Then queue row 12: the binned and COO kernels
    on band 0's plan of the skewed 1M-row matrix S, timed against their
    plain versions and cuSPARSE on the same band, the COO kernel also
    L2-cold.  Returns the two band kernels' records."""
    from cusp_autotuned_tpu_torch import parallel
    from cusp_autotuned_tpu_torch.kernels.binned import binned_spmv_plain
    from cusp_autotuned_tpu_torch.kernels.colsort import coo_spmv_plain
    from cusp_autotuned_tpu_torch.kernels.dia import (
        build_dia, dia_band_spmv, dia_band_spmv_plain)
    from cusp_autotuned_tpu_torch.ops.convert import convert

    mesh = parallel.make_row_mesh([device] * MESH_ENTRIES)
    D = convert(A_csr, "dia")
    op = parallel.shard_planned_dia(D, mesh)
    band = op.arrays[0]["data"].shape[1]
    left = -min(0, min(D.offsets))
    reach = (min(D.offsets), max(D.offsets))
    span = reach[1] - reach[0]
    k = len(D.offsets)
    log(f"dia_band_spmv / dia_band_spmm: {MESH_ENTRIES} bands of {band} rows of "
        f"poisson5pt 1000x1000 f32, each band kernel against its plain version "
        f"(rtol {BAND_RTOL}); useful bytes a band = k*band*4 + (band + "
        f"{span})*4*cols + band*4*cols")
    unsharded = build_dia(D, {})
    records = {}
    for cols in (0, 16):
        x = seeded_x(D.num_cols, 21, device) if cols == 0 \
            else seeded_block(D.num_cols, cols, 22, device)
        x_pad = op.x_prep(x)
        name = "dia_band_spmv" if cols == 0 else "dia_band_spmm"
        width = max(cols, 1)
        for i, arrs in enumerate(op.arrays):
            def kernel(arrs=arrs, i=i):
                return dia_band_spmv(arrs["data"], arrs["offsets"], x_pad, left,
                                     i * band, reach)

            def plain(arrs=arrs, i=i):
                return dia_band_spmv_plain(arrs["data"], D.offsets, x_pad, left,
                                           i * band)
            if i == 0:
                useful = k * band * 4 + (band + span) * 4 * width + band * 4 * width
                S0 = band_csr(A_csr, 0, band)
                records[name] = compare(
                    f"{name} band 0 of {MESH_ENTRIES}", kernel, plain, BAND_RTOL,
                    0.0, useful, 2 * k * band * width, triad_gbps,
                    library=lambda S0=S0: S0 @ x,
                    samples=SAMPLES if cols == 0 else SPMM_SAMPLES,
                    per_sample=PER_SAMPLE if cols == 0 else SPMM_PER_SAMPLE)
            else:
                y, yp = kernel(), plain()
                if not bool(((y - yp).abs() <= BAND_RTOL * yp.abs()).all()):
                    raise RuntimeError(f"{name}: band {i} differs from its plain "
                                       f"version")
        y_banded, y_whole = op(x), unsharded(x)
        torch.cuda.synchronize()
        if not bool(((y_banded - y_whole).abs() <= BAND_RTOL * y_whole.abs()).all()):
            raise RuntimeError(f"{name}: the banded product differs from the "
                               f"unsharded DIA kernel's")
        log(f"  {name}: every band matches its plain version; banded product "
            f"against the unsharded kernel's: max abs diff "
            f"{float((y_banded - y_whole).abs().max()):.3e}")

    x = seeded_x(S.num_cols, 27, device)
    band0 = -(-S.num_rows // MESH_ENTRIES)
    nnz0 = int(S.indptr[band0])
    scale = coo_spmv_plain(S.row[:nnz0], S.col[:nnz0], S.val[:nnz0].abs().double(),
                           x.abs().double(), band0).float()
    for name, build in (("binned", parallel.sharded_spmv_binned_shardmap),
                        ("coo", parallel.sharded_spmv_colsort_shardmap)):
        op = build(S, mesh)
        a, rows, nnz = op.arrays[0], band0, nnz0
        if name == "binned":
            def plain(a=a, rows=rows):
                return binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"],
                                         a["bins"], x, rows)
            useful = nnz * 8 + (rows + 1) * 4 + (S.num_cols + rows) * 4
        else:
            def plain(a=a, rows=rows):
                return coo_spmv_plain(a["row"], a["col"], a["val"], x, rows)
            useful = nnz * 12 + (S.num_cols + rows) * 4
        S0 = band_csr(S, 0, rows)
        label = (f"row 12: {name} on band 0 of {MESH_ENTRIES} of the skewed 1M-row "
                 f"matrix ({rows} rows, {nnz} entries)")
        compare(label, lambda op=op, a=a: op.band_apply(a, x, 0), plain, RAIL_RTOL,
                RAIL_ATOL, useful, 2 * nnz, triad_gbps,
                library=lambda S0=S0: S0 @ x, samples=RAIL_SAMPLES, scale=scale)
        if name == "coo":
            def band(v, op=op, a=a):
                return op.band_apply(a, v, 0)
            band.planned_arrays = a
            band.apply = lambda arrs, v, op=op: op.band_apply(arrs, v, 0)
            cold_line(label, band, x, useful, S0)
    return records


def timed_turns(fns, turns=("a", "b", "b", "a")):
    """Host seconds of each callable, run in turns, median per key."""
    times = {k: [] for k in fns}
    for k in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns[k]()
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0, out))
    return times


def rel_diff(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def multidevice_phase(device, A_csr, b, cgcu_its, cgcu_rel, M, b_amg, amg_its,
                      matrices):
    """The multidevice path; returns its launch counts."""
    from cusp_autotuned_tpu_torch import autotune, eigen, gallery, parallel, solvers
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops.convert import convert
    from cusp_autotuned_tpu_torch.parallel import ShardedPlannedOperator
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
    import scipy.sparse as sp

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True, capture_output=True,
                       text=True).stdout.strip()
        + f"; torch.cuda.device_count() {torch.cuda.device_count()}")
    mesh = parallel.make_row_mesh([device] * MESH_ENTRIES)
    log(f"multidevice: a mesh of {MESH_ENTRIES} entries on {mesh.devices[0]} "
        f"(one card; the same code drives {MESH_ENTRIES} cards)")
    D = convert(A_csr, "dia")
    # the Economics system of __graft_entry__.py:277-278, made before the path
    Se = gallery.williams_suite(SUITE_SCALE, names=["Economics"])["Economics"]
    Se = Se.astype(np.float32).tocsr()
    Se = (0.5 * (Se + Se.T)).tocsr()
    Se = (Se + sp.diags(np.abs(Se).sum(axis=1).A1 + 1.0)).tocsr()
    Ae = from_scipy(Se, "csr", dtype=torch.float32, device=device)
    del Se
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()

    # cg.cu through the banded via_dia plan
    op = parallel.shard_planned_dia(D, mesh)
    x, mon, solve_s = solve(op, b)
    its, rel = mon.iteration_count(), mon.residual_norm() / mon.b_norm
    log(f"multidevice: cg.cu through {op.impl}: {its} iterations (cg.cu path "
        f"{cgcu_its}), relative residual {rel:.6e} (cg.cu path {cgcu_rel:.6e}), "
        f"solve {solve_s:.3f} s")
    if its != cgcu_its or abs(rel - cgcu_rel) > 1e-3 * cgcu_rel \
            or not torch.isfinite(x).all():
        raise RuntimeError("multidevice: the banded cg.cu solve differs from the "
                           "cg.cu path's")
    X16 = seeded_block(D.num_cols, 16, 23, device)
    Y16 = op(X16)
    Y_plain, scale = plain_product(A_csr, X16)
    err = check_block("banded via_dia at k = 16", Y16, Y_plain, scale, "multidevice")
    log(f"multidevice: banded via_dia block apply at k = 16: max abs err {err:.3e} "
        f"against the plain product")

    # the fixed-iteration solvers, 25 iterations each
    xs = {"distributed_cg": parallel.distributed_cg(D, b, mesh)[0],
          "distributed_cg_shardmap": parallel.distributed_cg_shardmap(D, b, mesh)[0],
          "distributed_cg_halo": parallel.distributed_cg_halo(D, b, mesh)[0],
          "distributed_cg_binned": parallel.distributed_cg_binned(A_csr, b, mesh)[0]}
    xb, rb = parallel.distributed_bicgstab(A_csr, b, mesh)
    ref = xs["distributed_cg"]
    diffs = {k: rel_diff(v, ref) for k, v in xs.items()}
    log(f"multidevice: 25 iterations each, x against distributed_cg's (relative "
        f"2-norm): {diffs}; distributed_bicgstab residual {float(rb):.4e}")
    if max(diffs.values()) > SHARDED_CG_RTOL or not torch.isfinite(xb).all():
        raise RuntimeError("multidevice: the distributed CG variants disagree")

    # cg(A_csr, b, mesh=) on b = A x_true, against the unsharded CSR kernel solve
    x_m, mon_m = solvers.cg(A_csr, b_amg, monitor=Monitor(b_amg, 2000, 1e-5),
                            mesh=mesh)
    x_s, mon_s = solvers.cg(planned_operator(A_csr), b_amg,
                            monitor=Monitor(b_amg, 2000, 1e-5))
    log(f"multidevice: cg(A_csr, b, mesh=) {mon_m.iteration_count()} iterations, "
        f"converged {mon_m.converged()}; unsharded CSR kernel "
        f"{mon_s.iteration_count()}")
    if not mon_m.converged() or mon_m.iteration_count() != mon_s.iteration_count():
        raise RuntimeError("multidevice: cg(mesh=) differs from the unsharded solve")

    # queue row 12 at 1M rows
    S = matrices["random 1M rows, skewed"]
    xr = seeded_x(S.num_cols, 24, device)
    y_plain, _ = plain_product(S, xr)
    for name, build in (("binned", parallel.sharded_spmv_binned_shardmap),
                        ("colsort", parallel.sharded_spmv_colsort_shardmap)):
        e = rel_diff(build(S, mesh)(xr), y_plain)
        log(f"multidevice: sharded {name} SpMV on the skewed 1M-row matrix: "
            f"||y - y_plain|| / ||y_plain|| {e:.3e}")
        if e > ROW12_RTOL:
            raise RuntimeError(f"multidevice: sharded {name} SpMV differs")

    # AMG-CG over the mesh with the amg path's hierarchy
    A_op = autotune.tuned_operator(A_csr, mesh=mesh)
    t0 = time.perf_counter()
    Md = parallel.distribute_multilevel(M, mesh)
    setup_s = time.perf_counter() - t0
    if not isinstance(Md.levels[0].Aop, ShardedPlannedOperator) \
            or A_op.impl != "via_dia_sharded":
        raise RuntimeError(f"multidevice: level 0's A is {Md.levels[0].Aop.impl}, "
                           f"tuned_operator(A, mesh=) {A_op.impl}")
    describe_levels(Md)
    x_a, mon_a = solvers.cg(A_op, b_amg, M=Md, monitor=Monitor(b_amg, 2000, 1e-5),
                            mesh=mesh)
    log(f"multidevice: AMG-CG(mesh=) {mon_a.iteration_count()} iterations (amg "
        f"path {amg_its}), converged {mon_a.converged()}; distribute_multilevel "
        f"{setup_s:.2f} s; tuned_operator(A, mesh=) {A_op.impl}")
    if mon_a.iteration_count() != amg_its or not mon_a.converged():
        raise RuntimeError("multidevice: AMG-CG(mesh=) differs from the amg path")

    # shard_planned_blocks: routed on Economics, colsort2 on the power-law matrix
    cfg = {"impl": "routed", **ROUTED_CONFIG}
    op_r = parallel.shard_planned_blocks(Ae, mesh, cfg)
    be = torch.ones(Ae.num_rows, device=device)
    _, m_r = solvers.cg(op_r, be, monitor=Monitor(be, 500, 1e-6))
    _, m_1 = solvers.cg(planned_operator(Ae, cfg), be, monitor=Monitor(be, 500, 1e-6))
    log(f"multidevice: CG on Economics {Ae.num_rows} rows through {op_r.impl}: "
        f"{m_r.iteration_count()} iterations, single-device routed "
        f"{m_1.iteration_count()}")
    if not m_r.converged() or m_r.iteration_count() != m_1.iteration_count():
        raise RuntimeError("multidevice: the sharded routed CG differs")
    P = matrices["power-law 1M rows"]
    op_c = parallel.shard_planned_blocks(P, mesh, {"impl": "colsort2",
                                                   **COLSORT2_CONFIG})
    xp = seeded_x(P.num_cols, 25, device)
    yp_plain, scale = plain_product(P, xp)
    err = check_block("sharded colsort2 on the power-law matrix", op_c(xp),
                      yp_plain, scale, "multidevice")
    log(f"multidevice: {op_c.impl} ({op_c.out_mode}) on the power-law 1M-row "
        f"matrix: max abs err {err:.3e} against the plain product")

    # lanczos(mesh=) against the unsharded CSR-kernel operator
    lam_m = float(eigen.lanczos(A_csr, mesh=mesh)[0])
    lam_s = float(eigen.lanczos(planned_operator(A_csr))[0])
    log(f"multidevice: lanczos(mesh=) lambda_max {lam_m:.7f}, unsharded {lam_s:.7f}")
    if lam_m != lam_s:
        raise RuntimeError("multidevice: lanczos(mesh=) differs")
    launches = read_counts()
    log(f"multidevice: path in {time.perf_counter() - t_path:.1f} s; launches "
        f"{launches}")

    # timing: sharded against unsharded SpMV at 1M rows, and a CG iteration
    whole = planned_operator(A_csr, {"impl": "via_dia"})
    xt = seeded_x(A_csr.num_cols, 26, device)
    for name, fn in (("unsharded via_dia", whole), (op.impl, op)):
        before = read_counts()
        fn(xt)
        per_call = {k: v - before[k] for k, v in read_counts().items()
                    if v > before[k]}
        dev, kern, host = launch_calls(lambda: fn(xt), PER_SAMPLE)
        log(f"multidevice: SpMV {name}: {median_ms(lambda: fn(xt)):.4f} ms/call, "
            f"{dev:.4f} ms device (profiler, every kernel of a call), {kern:.1f} "
            f"kernels and {host:.1f} launch calls a call (wrappers {per_call})")
    turns = timed_turns({"a": lambda: solve(whole, b), "b": lambda: solve(op, b)})
    for k, name in (("a", "unsharded via_dia"), ("b", op.impl)):
        ms = [1e3 * s / max(out[1].iteration_count(), 1) for s, out in turns[k]]
        dev, kern, host = launch_calls(
            lambda: solvers.cg(whole if k == "a" else op, b,
                               monitor=Monitor(b, 32, 0.0)), 1)
        log(f"multidevice: CG {name}: {statistics.median(ms):.4f} ms/iteration "
            f"({', '.join(f'{v:.4f}' for v in ms)}), {kern / 32:.1f} kernels, "
            f"{host / 32:.1f} launch calls and {dev / 32:.4f} ms device an "
            f"iteration")
    return launches


def check_equal(name, y, y_shipped):
    """The probe's shipped mode against the shipped kernel: bit for bit."""
    torch.cuda.synchronize()
    if not torch.equal(y, y_shipped):
        raise RuntimeError(f"{name}: differs from the shipped kernel, max abs "
                           f"diff {float((y - y_shipped).abs().max()):.3e}")


def probes_phase(device, triad_gbps):
    """The four probe kernels in every mode against their plain versions on
    the card, and each probe's shipped mode against the shipped kernel bit
    for bit; then the probes path: the three probes' main() and the launch
    floor, with the counts set to 0 just before.  Returns (records of the
    four kernels, the path's launch counts)."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.benchmarks import (
        dia_probe, dia_spmm_probe, harness, routed_probe,
    )
    from cusp_autotuned_tpu_torch.kernels.dia import build_dia, dia_spmv_plain
    from cusp_autotuned_tpu_torch.kernels.routed import build_routed

    records = {}
    x = harness.floor_tile(device)
    records["launch_floor"] = compare(
        "launch_floor (8, 128) f32", lambda: harness.launch_floor(x),
        lambda: harness.launch_floor_plain(x), 0.0, 0.0, 8 * x.numel(),
        2 * x.numel(), triad_gbps)

    A = gallery.poisson5pt(1000, 1000, format="dia", device=device)
    x = seeded_x(A.num_cols, 0, device)
    shipped = build_dia(A, {})(x)
    log("probes: dia_probe on poisson5pt 1000x1000 f32 against its plain versions "
        "(rtol 1e-5, atol 1e-4), full equal to dia_spmv bit for bit:")
    for mode in dia_probe.MODES:
        for block in dia_probe.BLOCKS:
            fn = dia_probe.build_probe(A, block, mode)
            xin = fn.prepare(x)
            y = fn(xin)
            err = check_mode(f"dia_probe {mode} block={block}", y, dia_probe.dia_probe_plain(
                fn.planned_arrays["data"], A.offsets, xin, A.shape, mode,
                -min(A.offsets)), DIA_RTOL, DIA_ATOL)
            if mode in ("full", "nobounds"):
                check_equal(f"dia_probe {mode} block={block}", y, shipped)
            log(f"  {mode} block={block}: max abs err {err:.3e}")
    full = dia_probe.build_probe(A, 256, "full")
    records["dia_probe"] = compare(
        "dia_probe full (poisson5pt 1000x1000 f32)", lambda: full(x),
        lambda: dia_spmv_plain(A.data, A.offsets, x, A.shape), DIA_RTOL, DIA_ATOL,
        dia_probe.useful_bytes(A, "full"), 2 * A.num_diagonals * A.num_rows,
        triad_gbps, library_spmv(A, x))
    del x, shipped, full

    log("probes: dia_spmm_probe against its plain versions (rtol 1e-5, atol "
        "1e-4), shipped, team=T and xtile equal to dia_spmm bit for bit:")
    # the shapes main() times, and k = 3 for the narrow team
    for grid, k in dia_spmm_probe.SHAPES + ((1000, 3),):
        D = gallery.poisson5pt(grid, grid, format="dia", device=device)
        X = seeded_block(D.num_cols, k, 2, device)
        shipped = build_dia(D, {})(X)
        plain = {mode: dia_spmm_probe.dia_spmm_probe_plain(
            D.data, D.offsets, X, D.shape, mode) for mode in ("shipped", "nodata")}
        for mode in dia_spmm_probe.MODES:
            for block in (256, 1024):
                Y = dia_spmm_probe.build_probe(D, mode, block)(X)
                err = check_mode(f"dia_spmm_probe {mode} {grid}^2 k={k} block={block}",
                                 Y, plain["nodata" if mode == "nodata" else "shipped"],
                                 DIA_RTOL, DIA_ATOL)
                if mode != "nodata":
                    check_equal(f"dia_spmm_probe {mode} {grid}^2 k={k}", Y, shipped)
                log(f"  {mode} poisson5pt {grid}x{grid} k={k} block={block}: max abs "
                    f"err {err:.3e}")
                del Y
        del X, shipped, plain
    X = seeded_block(A.num_cols, 16, 2, device)
    fn = dia_spmm_probe.build_probe(A, "shipped")
    records["dia_spmm_probe"] = compare(
        "dia_spmm_probe shipped (poisson5pt 1000x1000 f32, k=16)", lambda: fn(X),
        lambda: dia_spmv_plain(A.data, A.offsets, X, A.shape), DIA_RTOL, DIA_ATOL,
        dia_spmm_probe.useful_bytes(A, 16), 2 * A.num_diagonals * A.num_rows * 16,
        triad_gbps, library_spmv(A, X), samples=SPMM_SAMPLES,
        per_sample=SPMM_PER_SAMPLE)
    del A, X, fn

    log("probes: routed_probe against its plain versions (rtol 1e-4, atol 1e-4 "
        "of each row's sum of |a x|), full equal to routed_spmv bit for bit:")
    for name in ("Economics", "LP"):
        R = routed_probe.suite_matrix(name, device)
        x = seeded_x(R.num_cols, 0, device)
        for config in routed_probe.CONFIGS:
            shipped = build_routed(R, config)(x)
            for mode in routed_probe.MODES:
                fn, info = routed_probe.build_probe(R, config, mode)
                a = fn.planned_arrays
                args = (R.shape, info["hub_cap"], mode)
                plain = routed_probe.routed_probe_plain(a, x, *args)
                scale = routed_probe.routed_probe_plain(
                    {**a, "val": a["val"].abs()}, x.abs(), *args)
                y = fn(x)
                err = check_mode(f"routed_probe {mode} {name} {config}", y, plain,
                                 RAIL_RTOL, RAIL_ATOL, scale)
                if mode == "full":
                    check_equal(f"routed_probe {mode} {name} {config}", y, shipped)
                log(f"  {mode} {name} {config}: max abs err {err:.3e}")
        if name == "Economics":
            fn, info = routed_probe.build_probe(R, routed_probe.CONFIGS[0], "full")
            a = fn.planned_arrays
            args = (R.shape, info["hub_cap"], "full")
            records["routed_probe"] = compare(
                "routed_probe full (Economics, the default plan)", lambda: fn(x),
                lambda: routed_probe.routed_probe_plain(a, x, *args), RAIL_RTOL,
                RAIL_ATOL, routed_probe.useful_bytes(R), 2 * R.nnz, triad_gbps,
                library_spmv(R, x), samples=RAIL_SAMPLES,
                scale=routed_probe.routed_probe_plain(
                    {**a, "val": a["val"].abs()}, x.abs(), *args))
        del R, x, shipped

    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()
    dia_probe.main(stream_gbps=triad_gbps)
    dia_spmm_probe.main(stream_gbps=triad_gbps)
    for name in ("Economics", "LP"):
        routed_probe.main(["routed_probe", name], stream_gbps=triad_gbps)
    floor = harness.launch_floor_s(device)
    log(f"probes: launch floor (8, 128) f32: {floor['per_call_s'] * 1e6:.3f} us a "
        f"launch back to back, {floor['graph_s'] * 1e6:.3f} us a launch in a CUDA "
        f"graph's replay, host cost {floor['host_s'] * 1e6:.3f} us a launch")
    launches = read_counts()
    log(f"probes: path in {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return records, launches


def bench_path(device, budget_s):
    """The bench path: cusp_autotuned_tpu_torch.bench.main in this process,
    with the counts set to 0 just before; checks that the headline was
    measured and that the launch floor and the triad ran on it."""
    from cusp_autotuned_tpu_torch import bench

    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()
    line = bench.main(budget_s=budget_s)
    launches = read_counts()
    log(f"bench: path in {time.perf_counter() - t_path:.1f} s (budget {budget_s} s "
        f"for the sweep); launches {launches}")
    value, sweep = line["value"], line["sweep"]
    if not (np.isfinite(value) and value > 0 and np.isfinite(line["vs_baseline"])):
        raise RuntimeError(f"bench: the headline was not measured: {line}")
    if "SpMV DIA poisson5pt(1000x1000)" not in line["metric"] \
            or "launch_host_us" not in sweep or "cgcu_1m_iters" not in sweep:
        raise RuntimeError(f"bench: the line lacks the headline or its first rows: "
                           f"{line}")
    unknown = set(sweep) - set(bench.SWEEP_KEYS) - {"truncated"}
    if unknown:
        raise RuntimeError(f"bench: sweep keys {sorted(unknown)} are not "
                           f"bench.SWEEP_KEYS")
    if launches["launch_floor"] < 1 or launches["stream_triad"] < 1:
        raise RuntimeError(f"bench: the launch floor or the triad did not launch "
                           f"on the bench path: {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch sees no CUDA device; the port's "
                 "kernels run only on a GPU")
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
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
        "random 1M rows, skewed": spmv_tiles.skewed(1_000_000, 2, device),
        "uniform random 1M x 1M": uniform_csr(1_000_000, 8, 3, device),
        "power-law 1M rows": powerlaw_csr(1_000_000, 10_000_000, 4, device),
    }
    log(f"matrices built in {time.perf_counter() - t0:.1f} s")
    records["csr_spmv"] = csr_phase(device, triad_gbps, matrices)
    records.update(rails_phase(device, triad_gbps, matrices))
    records["dia_spmm"] = dia_spmm_phase(device, triad_gbps)
    records.update(rails_spmm_phase(device, triad_gbps, matrices))
    records.update(new_rails_phase(device, triad_gbps, matrices))
    records["take_probe"] = take_probe_phase(device, triad_gbps)
    records.update(band_phase(device, triad_gbps,
                              matrices["poisson5pt 1000x1000 f32"],
                              matrices["random 1M rows, skewed"]))
    del matrices["uniform random 1M x 1M"]
    probe_records, probe_launches = probes_phase(device, triad_gbps)
    records.update(probe_records)

    cg_launches, b, viadia_its, viadia_rel = cg_phase(
        device, matrices["poisson5pt 1000x1000 f32"])
    amg_launches, amg_its, M, b_amg = amg_phase(device)
    mesh_launches = multidevice_phase(
        device, matrices["poisson5pt 1000x1000 f32"], b, viadia_its, viadia_rel,
        M, b_amg, amg_its, matrices)
    del M, b_amg, matrices["power-law 1M rows"]
    tuned_launches, _ = autotune_phase(device, matrices, b, viadia_its)
    spmm_launches = spmm_phase(device, matrices)
    del matrices
    suite_launches = suite_phase(device)
    bench_launches = bench_path(device, BENCH_BUDGET_S)
    log(f"launches: cg.cu path {cg_launches}; amg path {amg_launches}; "
        f"multidevice path {mesh_launches}; autotune path {tuned_launches}; spmm "
        f"path {spmm_launches}; suite path {suite_launches}; probes path "
        f"{probe_launches}; bench path {bench_launches}")
    missing = [k for k in SPMV_KERNELS if tuned_launches[k] < 1] + \
        [k for k in ("dia_spmv", "csr_spmv") if cg_launches[k] < 1] + \
        [k for k in ("dia_spmv", "csr_spmv", "take_probe") if amg_launches[k] < 1] + \
        [k for k in SPMM_KERNELS if spmm_launches[k] < 1] + \
        [k for k in SUITE_KERNELS if suite_launches[k] < 1] + \
        [k for k in MULTIDEVICE_KERNELS if mesh_launches[k] < 1] + \
        [k for k in PROBE_KERNELS if probe_launches[k] < 1] + \
        [k for k in ("launch_floor", "stream_triad") if bench_launches[k] < 1]
    if missing:
        raise RuntimeError(f"kernels not launched on their path: {missing}")
    within = [line for line in MODEL_LINES if line[2] <= MODEL_RATIO * line[4]]
    log(f"model: the cost model's pick within {MODEL_RATIO}x of the walk "
        f"leader's device time on {len(within)} of {len(MODEL_LINES)} matrices")
    for name, pick, pick_ms, lead, lead_ms in MODEL_LINES:
        log(f"    {name:28s} pick {label({'dia_impl': 'cuda', **pick}):12s} "
            f"{pick_ms:.4f} ms, leader {label(lead):12s} {lead_ms:.4f} ms, "
            f"ratio {pick_ms / lead_ms:.3f}")

    sources = {
        "dia_spmv": ("dia_spmv.cu", "cusp_autotuned_tpu/kernels/pallas_dia.py:393"),
        "csr_spmv": ("csr_spmv.cu", "cusp_autotuned_tpu/kernels/pallas_csr.py:171"),
        "binned_spmv": ("binned_spmv.cu",
                        "cusp_autotuned_tpu/kernels/pallas_binned.py:193"),
        "coo_spmv": ("coo_spmv.cu", "cusp_autotuned_tpu/kernels/pallas_colsort.py:162"),
        "stream_triad": ("stream_triad.cu",
                         "cusp_autotuned_tpu/autotune/calibrate.py:322; "
                         "benchmarks/harness.py:224"),
        "dia_spmm": ("dia_spmm.cu", "cusp_autotuned_tpu/kernels/pallas_dia.py:381"),
        "binned_spmm": ("binned_spmm.cu",
                        "cusp_autotuned_tpu/kernels/pallas_binned.py:229"),
        "coo_spmm": ("coo_spmm.cu",
                     "cusp_autotuned_tpu/kernels/pallas_colsort.py:885"),
        "colsort2_spmv": ("colsort2_spmv.cu",
                          "cusp_autotuned_tpu/kernels/pallas_colsort2.py:519"),
        "routed_spmv": ("routed_spmv.cu",
                        "cusp_autotuned_tpu/kernels/pallas_routed.py:426"),
        "colsort2_spmm": ("colsort2_spmm.cu",
                          "cusp_autotuned_tpu/kernels/pallas_colsort2.py:519"),
        "routed_spmm": ("routed_spmm.cu",
                        "cusp_autotuned_tpu/kernels/pallas_routed.py:426"),
        "take_probe": ("take_probe.cu",
                       "cusp_autotuned_tpu/autotune/calibrate.py:144"),
        "dia_band_spmv": ("dia_spmv.cu",
                          "cusp_autotuned_tpu/parallel/sharded_plans.py:154"),
        "dia_band_spmm": ("dia_spmm.cu",
                          "cusp_autotuned_tpu/parallel/sharded_plans.py:154"),
        "launch_floor": ("launch_floor.cu", "benchmarks/harness.py:279"),
        "dia_probe": ("dia_probe.cu", "benchmarks/dia_probe.py:27"),
        "dia_spmm_probe": ("dia_spmm_probe.cu", "benchmarks/dia_spmm_probe.py:29"),
        "routed_probe": ("routed_probe.cu", "benchmarks/routed_probe.py:44"),
    }
    kernels = []
    for name in KERNELS:
        r = records[name]
        bound_ms, bound_by = bound(r["bytes"], r["flops"])
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cusp_autotuned_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(path[name] for path in (
                cg_launches, amg_launches, mesh_launches, tuned_launches,
                spmm_launches, suite_launches, probe_launches, bench_launches)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
