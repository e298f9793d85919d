"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Twelve main paths, each driven with every kernel's launch count set to 0
just before it and read just after:

  cg.cu     the reference's cg.cu configuration: poisson5pt 1000x1000
            (1,000,000 unknowns), a via_dia planned operator, CG under a
            Monitor at rel-tol 1e-5 with at most 2000 iterations, then the
            true residual b - A x through the default CSR operator;
  krylov    the rest of the Krylov family on the cg.cu path's A and b:
            cr, bicg (A^T transposed on the card), bicgstab, cg_m and
            bicgstab_m (shifts 0, 0.5, 2) through the via_dia plan, and
            refine with its inner CG on the bf16 binned plan, at rel-tol
            1e-5 with at most 2000 iterations (refine: 12 sweeps); gmres(50),
            bicgstab with and without the diagonal preconditioner and bicg
            through the CSR kernel on a non-symmetric 1M-row matrix
            (tests/test_krylov.py's recipe, ~9M entries).  Each solve's
            iterations, residuals (monitored, and true through the CSR
            kernel), set-up and solve s, ms/iteration and launches; CR,
            BiCGstab and BiCGstab-M, which f32 keeps from the bar here in
            the JAX package too, are held to its reach (F32_JAX_REACH) and
            run again in f64, held to the bar.  Then each solver's kernel
            operator against its plain one at 100x100 and 10,000 rows, and
            the six solvers with mesh= on a 4-entry mesh against their
            unsharded solves and the JAX package's counts at
            __graft_entry__.py's multichip input;
  graph     the graph slice on the cg.cu path's A and b: BFS levels (each
            level one CSR-kernel SpMV of the pattern) and predecessors from
            vertex 0, connected_components (and on a block-diagonal pair of
            grids), MIS(1), MIS(2) and vertex_coloring checked by plain
            SpMVs, hilbert_curve of the grid's coordinates into 4 parts;
            symmetric_rcm of A under a seeded random symmetric permutation
            (the bandwidth before and after; rcm_dia refused by the DIA fill
            guard there), CG through rcm_dia (dia_spmv) on a scrambled 1M-row
            strip against via_dia on the unscrambled one; AMG-CG with
            smoothed_aggregation(A, aggregator='mis', smoother=
            'gauss_seidel' or 'sor', spmv_config={}) against plain CG, and
            the 150x150 f64 MIS/Gauss-Seidel solve held to the JAX
            package's count; CG with bridson_ainv and scaled_bridson_ainv
            on the cg.cu system and BiCGstab with nonsym_bridson_ainv on the
            krylov path's non-symmetric recipe at 100,000 rows, each against
            its solve without M; then each algorithm on a planned operator
            against the plain path at 100x100 and 10,000 rows;
  spgemm    sparse products on the cg.cu path's A (poisson5pt 1000x1000
            CSR f32, 4,996,000 entries): C = multiply(A, A) (24,964,008
            expanded products, so two slices of at most 16 << 20 and a
            merge) against scipy's A @ A bit for bit and against a second
            call bit for bit; C x through the via_dia plan (dia_spmv, 13
            diagonals) and a CSR plan (csr_spmv) against A (A x) through
            A's via_dia plan; the Galerkin chain spgemm(P^T, spgemm(A, P))
            on smoothed_aggregation(A)'s first prolongator against the
            host's galerkin_product; min-plus generalized_spgemm on
            grid2d(1000, 1000) with a zero diagonal added on the card (every
            entry the Manhattan distance, the pattern that of A A, two
            slices) and on tests/test_ops.py:266's 10,000-row f64 recipe
            against the CPU's; multiply(X^T, A) for a seeded X (1M x 16)
            against (A^T X)^T through the via_dia plan (dia_spmm); the
            product's s, slices, kernels and launch calls, peak device
            memory, scipy's time and cuSPARSE's (torch.sparse CSR @ CSR) as
            yardsticks;
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
            validated walk (tune) on poisson5pt 1000x1000 CSR through the
            offline CLI's main(["poisson5pt:1000", "--json"]) in this
            process (its leaders' device_time.device_us_per_call held to
            device_ms within 5 %) and on a skewed 1M-row CSR,
            the cg.cu solve through tuned_operator (timed in turns with the
            via_dia solve), the dynamic multiply
            hook on a 65,536-row diagonal matrix, and choose_format over
            dia, ell, ellr, csr, coo and hyb on poisson5pt 500x500 (six
            walks; 67 s at 1000x1000 on the card's host);
  spmm      the block multiply: the tuner's walk on poisson5pt 1000x1000
            CSR with a seeded X (1,000,000 x 16) under its per-k signature,
            tuned_operator(A, X) applied to X, the multiply hook on an
            Array2d of X, the walk and tuned_operator on the skewed 1M-row
            matrix at k = 16, eigen.lobpcg (100 iterations) on the operator
            tuned for a (n, 3) block, and a 100x100 LOBPCG against the
            analytic eigenvalue and against the plain operator;
  entry points
            python -m cusp_autotuned_tpu_torch.autotune as a process of
            its own on a .mtx of poisson5pt 200x200 with --choose-format,
            --budget 1 (a budget of 10 s lets the whole walk through) and
            --json (the coverage note, best_format against the
            oracle); impl="cusparse" (backend/tsparse.py) on poisson5pt
            1000x1000 and the skewed 1M-row CSR against the oracle, its
            device ms beside the CSR kernel's in turns, and the cuSPARSE
            yardstick's canonical tensor against the stored arrays; the
            nine examples (cusp_autotuned_tpu_torch/examples) on the card
            and on the CPU, their counts held together;
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
               card's triad GB/s, the denominator of every bound below;
               torch.add(b, c, alpha=s, out=a) timed beside it (the same
               bytes, not the same function)
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
               (~8 entries a row) and a power-law 1M-row matrix, two calls
               equal bit for bit; the binned kernel on its walk's edges
               (rows of 32 and 33 entries and of hub_cap and hub_cap + 1,
               runs of empty rows, LP's rows, rows that read x's end) and
               L2-cold beside cuSPARSE on poisson and the skewed 1M (row
               5); the COO kernel on poisson also L2-cold (row 6)
  dia_spmm     the DIA SpMM kernel against its plain version: poisson5pt
               1000x1000 at k = 3, 16 and 128 in f32 and bf16 storage, the
               JAX package's DIA SpMM test shapes, and the edges of its
               schedule (k = 5, 33 and 130, X on 8- and 4-byte boundaries),
               two calls equal bit for bit; then L2-cold beside cuSPARSE at
               k = 3, 16 and 128 (queue row 3)
  binned_spmm, coo_spmm
               the row-binned and COO SpMM kernels against their plain
               versions at k = 16 on the four matrices above, and on the JAX
               package's SpMM test shapes, two calls equal bit for bit; the
               COO kernel also at k = 5, 33 and 130 and on X off a 16-byte
               boundary; both L2-cold beside cuSPARSE at k = 3, 16 and 128
               on poisson5pt 1000x1000 and the skewed 1M-row matrix (rows
               5' and 6')
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
               package's SpMM test shapes of the two rails, two calls equal
               bit for bit; both also at k = 3, 5, 16, 33, 128 (routed) and
               130 and on X off a 16-byte boundary (a skewed 20000-row
               matrix with hub rows), every load path's Y equal, routed's
               equal to the colsort2 SpMM's with one plane bit for bit; and
               L2-cold beside cuSPARSE at k = 3, 16 and 128 on poisson5pt
               1000x1000 and the skewed 1M-row matrix (rows 7 and 8)
  dia_band_spmv, dia_band_spmm
               the DIA band kernels against their plain versions on every
               row band of poisson5pt 1000x1000 f32 over a mesh of four
               entries, a vector and k = 16, rtol 1e-6, and the banded
               product against the unsharded DIA kernel's (at k = 16 bit for
               bit); band 0 at k = 16 also L2-cold beside cuSPARSE (row 11)
  launch_floor, dia_probe, dia_spmm_probe, routed_probe
               the measurement path's four kernels in every mode against
               their plain versions (the launch floor bit for bit; DIA at
               rtol 1e-5, atol 1e-4; routed at the rails' 1e-4 of each
               row's sum of |a x|), and each probe's shipped mode against
               the shipped kernel bit for bit (dia_probe full and nobounds
               against dia_spmv at four block sizes; dia_spmm_probe
               shipped, rows=R, team=T and xtile against dia_spmm on every
               shape its main() times, poisson5pt 1000x1000 at k = 3, 16
               and 128 and 300x300 at k = 128;
               routed_probe full against routed_spmv on
               Economics and LP, two plans each), then the probes path
  take_probe   the take probe (both instantiations: x staged in shared
               memory, x read through L1/L2) against its plain version at
               64 tiles and 2, 3 and 18 passes, rtol 1e-6, then timed at
               4096 tiles and 18 passes, and the two-point tile_take_ns
  cg           the cg.cu path; then a 100x100 solve through the kernel
               operator against one through the plain operator
  krylov       the krylov path
  graph        the graph path
  spgemm       the spgemm path
  amg          the amg path
  autotune     the autotune path
  spmm         the spmm path, with the untuned default (binned) against
               each k = 16 walk's leader, timed again side by side
  entry points the entry-points path
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
same product, that call's time (cuSPARSE through backend/tsparse.py's
to_torch_sparse, times a vector or the dense block, timed as a yardstick
only; no tuning walk or default plan calls it).  Any failed check
raises, and the script exits non-zero.  It exits non-zero at once where
torch sees no CUDA device.  Its last two lines are the kernels' JSON record
and {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from cusp_autotuned_tpu_torch.utils.device_time import (
    device_kernels, device_ms, kernel_name, read_counts, reset_counts,
)

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
# the phases' plans of the two new rails: two planes of 8 entries (rows
# above 16 entries in the hub region), and routed in blocks of 256
COLSORT2_CONFIG = {"vrow_planes": 2, "vrow_len": 8, "block_size": 256}
ROUTED_CONFIG = {"block_size": 256}
SUITE_SCALE = 2.0
TAKE_RTOL = 1e-6                     # tests/test_calibrate.py:117
SPMM_EDGE_KS = (3, 5, 16, 33, 128, 130)  # the binned and routed SpMMs' edges
JAX_AMG_150_ITERATIONS = 20          # the JAX package's AMG-CG count at 150x150
                                     # (bench.py's amg_cg_iters configuration;
                                     # tests/test_torch_amg.py holds the port
                                     # to it on the CPU)
MODEL_RATIO = 1.25                   # the model's pick against the walk leader
LEADER_AGREEMENT = 0.05              # device_us_per_call against device_ms
CLI_BUDGET_S = 1.0                   # cuts the CLI's walk of poisson5pt 200x200
EXAMPLE_F32_SLACK = 2                # iterations, card against CPU, f32 CG
EXAMPLE_F64_COUNTS = {("03_amg_preconditioner", "amg_iterations"),
                      ("03_amg_preconditioner", "cg_iterations")}
# the kernels the entry-points path must launch: its examples' and the
# CLI's (csr via the `cuda` impl, dia via via_dia, the rails, and example
# 06's DIA bands)
ENTRY_KERNELS = ("dia_spmv", "csr_spmv", "binned_spmv", "coo_spmv",
                 "colsort2_spmv", "dia_band_spmv")
REPO = os.path.dirname(os.path.abspath(__file__))
CARD = [""]                          # nvidia-smi's name and power limit
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
    """A as a torch.sparse_csr_tensor with f32 values, for the yardstick:
    backend/tsparse.py's to_torch_sparse (a CSR container's own arrays
    where its columns are sorted and unique in each row)."""
    from cusp_autotuned_tpu_torch.backend.tsparse import to_torch_sparse
    S = to_torch_sparse(A)
    if S.dtype == torch.float32:
        return S
    return torch.sparse_csr_tensor(S.crow_indices(), S.col_indices(),
                                   S.values().float(), size=S.shape)


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
    # no one PyTorch call computes y = 0.5 y + 0.25 x; the STREAM triad
    # a = b + s c moves the same 12 bytes an element
    z = torch.empty_like(x)
    add_ms = median_ms(lambda: torch.add(y0, x, alpha=0.25, out=z))
    log(f"  yardstick, not the same function: torch.add(b, c, alpha=s, out=a) "
        f"on the same {n} elements {add_ms:.4f} ms/call")
    del z
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


def cold_line(label, fn, x, nbytes, library=None, library_x=None):
    """Print fn's and the library call's L2-cold times (spmv_tiles.cold and
    library_cold, through harness.time_cold: device ms from a graph's
    replay, ms a call back to back), beside the bound at the data-sheet
    rate.  fn is a plan (planned_arrays, apply), so that each copy holds
    arrays of its own; library is a sparse CSR tensor, applied to
    library_x where given (a band plan's x is padded), else to x."""
    from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
    dev, call = spmv_tiles.cold(fn, x, nbytes, samples=RAIL_SAMPLES)
    line = (f"  {label}, L2-cold: {dev:.4f} ms device, {call:.4f} "
            f"ms a call; bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    if library is not None:
        ldev, lcall = spmv_tiles.library_cold(library,
                                              x if library_x is None else library_x,
                                              nbytes,
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
        "entries cancel); default plans (binned: a lane a row of at most 32 "
        "entries, a warp up to hub_cap 1024, a block past it; coo: chunks of "
        "128 entries); useful bytes, the matrix as CSR or COO once "
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
        log(f"    binned: {fb.plan_stats['long_rows']} rows a warp, "
            f"{fb.plan_stats['hub_rows']} rows a block")
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
        if not torch.equal(fb(x), fb(x)):
            raise RuntimeError(f"binned_spmv {name}: two calls differ")
        if name in ("poisson5pt 1000x1000 f32", "random 1M rows, skewed"):
            S = sparse_csr(A)
            cold_line(f"row 5: binned {name}", fb, x,
                      nnz * 8 + (m + 1) * 4 + (n + m) * 4, S)
        if name == "poisson5pt 1000x1000 f32":
            if not torch.equal(fc(x), fc(x)):
                raise RuntimeError("coo_spmv: two calls differ")
            cold_line(f"row 6: coo {name}", fc, x, nnz * 12 + (n + m) * 4, S)
        del fb, fc, a, c, scale
    # the walk's edges (csrc/binned_spmv.cu on rail_rows.cuh): rows of 32
    # and 33 entries (a lane or a warp) and of hub_cap and hub_cap + 1 (a
    # warp or a block), runs of empty rows, LP's rows of ~1,300 entries (a
    # warp or a block each), rows that read x's end
    edges = edge_csr([16, 17, 32, 33, 64, 65, 5, 0] * 700, 20000, 21, device)
    gaps = edge_csr([0] * 40 + ([3, 0, 33] + [0] * 100 + [7] * 40 + [0] * 1000)
                    * 30 + [0] * 70, 5000, 22, device)
    lp = lp_csr(device)
    tail = edge_csr([16] * 4096, 4998, 23, device, tail_cols=300)
    log("binned_spmv: the walk's edges against the plain version, two calls "
        "equal bit for bit")
    for name, A, cfg in (("edges 16/17/32/33/64/65", edges, {"hub_cap": 64}),
                         ("edges 16/17/32/33/64/65", edges,
                          {"hub_cap": 16, "block_size": 512}),
                         ("runs of 40 to 1000 empty rows", gaps, {"hub_cap": 32}),
                         ("Williams LP (suite 2.0)", lp, {}),
                         ("Williams LP (suite 2.0)", lp, {"hub_cap": 1300}),
                         ("rows that read x's end (n 4998)", tail, {})):
        fb = build_binned(A, cfg)
        a, st = fb.planned_arrays, fb.plan_stats
        x = seeded_x(A.num_cols, 5, device)
        y = fb(x)
        _, scale = plain_product(A, x)
        err = check_mode(f"binned_spmv {name} {cfg}", y, binned_spmv_plain(
            a["indptr"], a["col"], a["val"], a["perm"], a["bins"], x, A.num_rows),
            RAIL_RTOL, RAIL_ATOL, scale)
        if not torch.equal(fb(x), y):
            raise RuntimeError(f"binned_spmv {name} {cfg}: two calls differ")
        log(f"  binned_spmv {name} {cfg} ({st['long_rows']} rows a warp, "
            f"{st['hub_rows']} a block): max abs err {err:.3e}; two calls equal "
            f"bit for bit")
        del fb, a, x, y, scale
    return {k: v["poisson5pt 1000x1000 f32"] for k, v in out.items()}


def seeded_block(n, k, seed, device):
    X = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    return torch.from_numpy(X).to(device)


def misaligned(X, offset):
    """A contiguous copy of X `offset` values past the start of its memory
    (an f32 X: 2 puts it on an 8-byte boundary, 1 on a 4-byte one)."""
    flat = torch.empty(X.numel() + offset, dtype=X.dtype, device=X.device)
    out = flat[offset:].view(X.shape)
    out.copy_(X)
    return out


def spmm_edges(name, fn, plain, scale, n, ks, device, across=True):
    """fn(X) against plain(X) (rtol RAIL_RTOL of `scale`(X)) at each k of ks
    with X on a 16-, 8- and 4-byte boundary: the SpMM schedule's 16-byte,
    8-byte and one-value paths; two calls equal bit for bit, and where
    `across` (a sum's order does not depend on the width) every path's Y
    equal to the first's."""
    for k in ks:
        X = seeded_block(n, k, 6, device)
        first = None
        for offset in (0, 2, 1):
            Xo = misaligned(X, offset)
            Y = fn(Xo)
            err = check_mode(f"{name} k={k} X +{4 * offset} B", Y, plain(Xo),
                             RAIL_RTOL, RAIL_ATOL, scale(Xo))
            first = Y if first is None else first
            if not ((torch.equal(Y, first) or not across) and torch.equal(fn(Xo), Y)):
                raise RuntimeError(f"{name} k={k} X +{4 * offset} B: differs from "
                                   f"the 16-byte path or between two calls")
            log(f"  {name} k={k}, X {4 * offset} bytes past a 16-byte boundary: "
                f"max abs err {err:.3e}; "
                + ("equal to the 16-byte path and " if across else "")
                + "two calls equal bit for bit")
        del X, Xo, Y, first


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
        if not torch.equal(fn(X), fn(X)):
            raise RuntimeError(f"dia_spmm {name}: two calls differ")
        del X, scale
    mid = gallery.poisson5pt(300, 300, format="dia", device=device)
    fm = build_dia(mid, {})
    log("dia_spmm: the schedule's edges on poisson5pt 300x300 f32")
    spmm_edges("dia_spmm poisson5pt 300x300", fm,
               lambda X: dia_spmv_plain(mid.data, mid.offsets, X, mid.shape),
               lambda X: dia_spmv_plain(mid.data.abs().double(), mid.offsets,
                                        X.abs().double(), mid.shape).float(),
               mid.num_cols, (3, 5, 16, 33, 130), device)
    for k in (3, 16, 128):
        X = seeded_block(big.num_cols, k, 3, device)
        cold_line(f"row 3: dia_spmm poisson5pt 1000x1000 f32 k={k}",
                  build_dia(big, {}), X, big.num_diagonals * big.rows_padded * 4
                  + (big.num_rows + big.num_cols) * k * 4, big_csr)
        del X
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
            f"binned {name} ({fb.plan_stats['spmm_hub_rows']} rows above spmm_cap "
            f"{fb.plan_stats['spmm_cap']})", lambda: fb(X),
            lambda: binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"],
                                      a["bins"], X, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 8 + (m + 1) * 4 + (n + m) * k * 4,
            2 * nnz * k, triad_gbps, library, SPMM_SAMPLES, scale, SPMM_PER_SAMPLE)
        out["coo_spmm"][name] = compare(
            f"coo {name}", lambda: fc(X),
            lambda: coo_spmv_plain(c["row"], c["col"], c["val"], X, m),
            RAIL_RTOL, RAIL_ATOL, nnz * 12 + (n + m) * k * 4, 2 * nnz * k,
            triad_gbps, library, SPMM_SAMPLES, scale, SPMM_PER_SAMPLE)
        if not torch.equal(fc(X), fc(X)):
            raise RuntimeError(f"coo_spmm {name}: two calls differ")
        if not torch.equal(fb(X), fb(X)):
            raise RuntimeError(f"binned_spmm {name}: two calls differ")
        del fb, fc, a, c, scale, X, library
    mid = gallery.poisson5pt(300, 300, format="csr", device=device)
    fm = build_colsort(mid, {})
    c = fm.planned_arrays
    log("coo_spmm: the schedule's edges on poisson5pt 300x300 f32")
    spmm_edges("coo_spmm poisson5pt 300x300", fm,
               lambda X: coo_spmv_plain(c["row"], c["col"], c["val"], X,
                                        mid.num_rows),
               lambda X: coo_spmv_plain(c["row"], c["col"], c["val"].abs().double(),
                                        X.abs().double(), mid.num_rows).float(),
               mid.num_cols, (3, 5, 16, 33, 130), device,
               across=False)     # a team's segment of a chunk is vpt T entries
    binned_spmm_edges(device)
    log("rows 5' and 6', L2-cold: useful bytes binned nnz*(4+4) + (m+1)*4 + "
        "(n+m)*k*4, coo nnz*(4+4+4) + (n+m)*k*4")
    for name in ("poisson5pt 1000x1000 f32", "random 1M rows, skewed"):
        A = matrices[name]
        S = sparse_csr(A)
        for k in (3, 16, 128):
            X = seeded_block(A.num_cols, k, 5, device)
            cold_line(f"row 6': coo_spmm {name} k={k}", build_colsort(A, {}), X,
                      A.nnz * 12 + (A.num_rows + A.num_cols) * k * 4, S)
            cold_line(f"row 5': binned_spmm {name} k={k}", build_binned(A, {}), X,
                      A.nnz * 8 + (A.num_rows + 1) * 4
                      + (A.num_rows + A.num_cols) * k * 4)
            del X
        del S
    return {k: v["poisson5pt 1000x1000 f32 k=16"] for k, v in out.items()}


def binned_spmm_edges(device):
    """The binned SpMM on a skewed 20000-row matrix with its rows' columns
    sorted (routed's plan), at routed's default hub_cap and 32: against the
    plain version on X at three alignments for threads_per_row 0, and at
    every k of SPMM_EDGE_KS equal bit for bit to the routed SpMM (the same
    walk in row order, the same hub pair) for threads_per_row 0, 1 and 4,
    on X 0 and 4 bytes past a 16-byte boundary."""
    from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    from cusp_autotuned_tpu_torch.kernels.binned import binned_spmv_plain, build_binned
    from cusp_autotuned_tpu_torch.kernels.routed import build_routed

    log("binned_spmm: the schedule's edges on a skewed 20000-row matrix with "
        "sorted columns, at routed's default hub_cap and 32; its Y equal bit for "
        "bit to the routed SpMM's at the same hub_cap for threads_per_row 0, 1 "
        "and 4")
    E = spmv_tiles.skewed(20_000, 5, device)
    for cfg in ({}, {"hub_cap": 32}):
        fr = build_routed(E, {**ROUTED_CONFIG, **cfg})
        r, cap = fr.planned_arrays, fr.plan_stats["hub_cap"]
        Es = csr_matrix(r["indptr"], r["col"], r["val"], E.shape, device=device)
        fbs = {tpr: build_binned(Es, {"hub_cap": cap, "threads_per_row": tpr})
               for tpr in (0, 1, 4)}
        a = fbs[0].planned_arrays

        def plain(X, a=a, abs_=False):
            return binned_spmv_plain(
                a["indptr"], a["col"], a["val"].abs().double() if abs_ else a["val"],
                a["perm"], a["bins"], X.abs().double() if abs_ else X, E.num_rows)
        spmm_edges(f"binned_spmm hub_cap {cap} ({fbs[0].plan_stats['spmm_hub_rows']} "
                   f"hub rows)", fbs[0], plain, lambda X: plain(X, abs_=True).float(),
                   E.num_cols, SPMM_EDGE_KS, device)
        for k in SPMM_EDGE_KS:
            X = seeded_block(E.num_cols, k, 6, device)
            for offset in (0, 1):
                Xo = misaligned(X, offset)
                Yr = fr(Xo)
                for tpr, fb in fbs.items():
                    if not torch.equal(fb(Xo), Yr):
                        raise RuntimeError(
                            f"binned_spmm hub_cap {cap} threads_per_row {tpr} k={k} "
                            f"X +{4 * offset} B: Y differs from the routed SpMM's")
        log(f"  binned_spmm hub_cap {cap}: Y of threads_per_row 0, 1 and 4 equal "
            f"to one another and to the routed SpMM's bit for bit at k = "
            f"{SPMM_EDGE_KS}, X 0 and 4 bytes past a 16-byte boundary")
        del fr, r, Es, fbs, a, X, Xo, Yr


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
        ("Williams LP (suite 2.0), default plans", lp, {"vrow_len": 0}, {}, 0),
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
        if not torch.equal(fc(X), fc(X)):
            raise RuntimeError(f"colsort2_{kind} {name}: two calls differ")
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
            f"{st['long_rows']} long rows)", lambda: fr(X),
            lambda: routed_spmv_plain(r["indptr"], r["col"], r["val"], r["hub"], X, m,
                                      st["hub_cap"]),
            RAIL_RTOL, RAIL_ATOL, useful, flops, triad_gbps, library, samples, scale,
            per_sample)
        if not torch.equal(fr(X), fr(X)):
            raise RuntimeError(f"routed_{kind} {name}: two calls differ")
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

    log("colsort2_spmm: the schedule's edges on a skewed 20000-row matrix (hub "
        "rows too), chip_smoke's plan and the default")
    from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
    E = spmv_tiles.skewed(20_000, 5, device)
    for cfg in (COLSORT2_CONFIG, {}):
        fe = build_colsort2(E, cfg)
        a, st = fe.planned_arrays, fe.plan_stats

        def plain(X, a=a, st=st, abs_=False):
            return colsort2_spmv_plain(
                a["indptr"], a["col"], a["val"].abs().double() if abs_ else a["val"],
                a["hub"], X.abs().double() if abs_ else X, E.num_rows,
                st["vrow_planes"], st["vrow_len"], st["thr"])
        spmm_edges(f"colsort2_spmm {cfg or 'default'} ({st['hub_rows']} hub rows)",
                   fe, plain, lambda X: plain(X, abs_=True).float(), E.num_cols,
                   (3, 5, 16, 33, 130), device)
        del fe, a
    log("routed_spmm: the schedule's edges on the same matrix, the default "
        "hub_cap and 32; its Y equal bit for bit to the colsort2 SpMM's with "
        "one plane of hub_cap entries (vrow_planes 1, vrow_len hub_cap) on "
        "routed's plan, whose rows hold their columns in ascending order")
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    for cfg in ({}, {"hub_cap": 32}):
        fe = build_routed(E, {**ROUTED_CONFIG, **cfg})
        r, st = fe.planned_arrays, fe.plan_stats
        cap = st["hub_cap"]
        one_plane = build_colsort2(
            csr_matrix(r["indptr"], r["col"], r["val"], E.shape, device=device),
            {"vrow_planes": 1, "vrow_len": cap, "hub_cap": cap})

        def plain(X, r=r, cap=cap, abs_=False):
            return routed_spmv_plain(
                r["indptr"], r["col"], r["val"].abs().double() if abs_ else r["val"],
                r["hub"], X.abs().double() if abs_ else X, E.num_rows, cap)
        spmm_edges(f"routed_spmm hub_cap {cap} (tail {st['tail']} entries)", fe,
                   plain, lambda X: plain(X, abs_=True).float(), E.num_cols,
                   SPMM_EDGE_KS, device)
        for k in SPMM_EDGE_KS:
            X = seeded_block(E.num_cols, k, 6, device)
            if not torch.equal(fe(X), one_plane(X)):
                raise RuntimeError(f"routed_spmm hub_cap {cap} k={k}: Y differs "
                                   f"from the colsort2 SpMM's with one plane")
        log(f"  routed_spmm hub_cap {cap}: Y equal to colsort2's one plane bit "
            f"for bit at k = {SPMM_EDGE_KS}")
        del fe, r, one_plane
    log("rows 7 and 8's SpMM, L2-cold: useful bytes nnz*(4+4) + (m+1)*4 + "
        "(n+m)*k*4")
    for name in ("poisson5pt 1000x1000 f32", "random 1M rows, skewed"):
        A = matrices[name]
        for k in (3, 16, 128):
            X = seeded_block(A.num_cols, k, 5, device)
            S = sparse_csr(A)
            for label, build, cfg in (("colsort2", build_colsort2, COLSORT2_CONFIG),
                                      ("colsort2", build_colsort2, {}),
                                      ("routed", build_routed, {})):
                row = 7 if label == "colsort2" else 8
                cold_line(f"row {row}: {label}_spmm {cfg or 'default'} {name} k={k}",
                          build(A, cfg), X, A.nnz * 8 + (A.num_rows + 1) * 4
                          + (A.num_rows + A.num_cols) * k * 4, S)
                S = None              # cuSPARSE once a (matrix, k)
            del X
    return {"colsort2_spmv": out["colsort2_spmv"]["poisson5pt 1000x1000 f32"],
            "routed_spmv": out["routed_spmv"]["poisson5pt 1000x1000 f32"],
            "colsort2_spmm": out["colsort2_spmm"]["poisson5pt 1000x1000 f32 k=16"],
            "routed_spmm": out["routed_spmm"]["poisson5pt 1000x1000 f32 k=16"]}


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


# the krylov path: the shifts of __graft_entry__.py:220, the JAX package's
# iteration counts at its multichip input (MULTICHIP_r05.json, printed by
# __graft_entry__.py:177-236), and the kernels the path must launch
KRYLOV_SIGMA = (0.0, 0.5, 2.0)
JAX_MESH_COUNTS = {"bicg": 56, "gmres": 102, "cr": 56, "bicgstab": 43,
                   "cg_m": 62, "bicgstab_m": 46}
KRYLOV_KERNELS = ("dia_spmv", "csr_spmv", "binned_spmv")
NONSYM_SEED = 5
KRYLOV_PROFILE_ITS = 32              # iterations a profiled solve runs
# f32 on the cg.cu system (A of condition ~4e5) keeps CR, BiCGstab and
# BiCGstab-M from the bar in the JAX package too: {solver: (the JAX
# package's last monitored relative residual, whether its x is finite)},
# from tests/krylov_f32_reach.py on the CPU (PERF.md §7).  Each of these f32
# solves keeps x of shape n, finite where the JAX package's is, and a
# residual that stalls there (below 1) within STALL_SLACK of the JAX
# package's; the same solves run again in f64, held to the bar
F32_JAX_REACH = {"cr": (0.28302, True), "bicgstab": (float("nan"), False),
                 "bicgstab_m": (float("nan"), False)}
STALL_SLACK = 1.1
# the f32 mesh= counts may differ from the JAX package's by the rounding of
# torch's and XLA's sums: by 1, and bicgstab, whose f32 history on this input
# is erratic, by 2 (tests/test_torch_krylov_mesh.py says why)
MESH_JAX_SLACK = {"bicgstab": 2}


def nonsym_csr(n, seed, device):
    """tests/test_krylov.py:19-23's non-symmetric recipe at n rows: 8 seeded
    uniform [0, 1) values a row at random columns, duplicates merged, plus
    6 I (diagonally dominant on average)."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    rng = np.random.RandomState(seed)
    S = sp.csr_matrix((rng.rand(8 * n), (np.repeat(np.arange(n), 8),
                                          rng.randint(0, n, 8 * n))), shape=(n, n))
    S = (S + sp.diags(np.full(n, 6.0))).tocsr().astype(np.float32)
    S.sort_indices()
    return csr_matrix(S.indptr, S.indices, S.data, (n, n), device=device)


def true_residual(apply, x, b, sigma=None):
    """||b - A x|| / ||b|| through `apply`; for a block of shifted
    solutions the largest of ||b - (A + s I) x_s|| / ||b||."""
    from cusp_autotuned_tpu_torch.ops import blas
    if sigma is None:
        return float(blas.nrm2(b - apply(x)) / blas.nrm2(b))
    return max(float(blas.nrm2(b - apply(xs) - s * xs) / blas.nrm2(b))
               for xs, s in zip(x, sigma.tolist()))


def oracle_residual(A, x, b, sigma=None):
    """The same by the scipy oracle, in f64 on the host."""
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    S = to_scipy(A).astype(np.float64)
    bh, xh = b.double().cpu().numpy(), x.double().cpu().numpy()
    if sigma is None:
        return float(np.linalg.norm(bh - S @ xh) / np.linalg.norm(bh))
    return max(float(np.linalg.norm(bh - S @ xs - s * xs) / np.linalg.norm(bh))
               for xs, s in zip(xh, sigma.tolist()))


def krylov_solves(ops, b, sigma, refine_cfg, inner):
    """{label: (problem, call(limit, rtol) -> (x, monitor), shifted)}: the
    krylov path's solves on `ops` (A and A^T planned on the DIA rail, N and
    N^T on the CSR kernel, N's diagonal preconditioner M, and the container
    A_csr that refine plans itself)."""
    from cusp_autotuned_tpu_torch import solvers
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
    A, At, N, Nt, M, A_csr = ops

    def mon(limit, rtol):
        return Monitor(b, limit, rtol)
    return {
        "cr": ("poisson", lambda l, t: solvers.cr(A, b, monitor=mon(l, t)), False),
        "bicg": ("poisson", lambda l, t: solvers.bicg(A, b, monitor=mon(l, t), At=At),
                 False),
        "bicgstab": ("poisson", lambda l, t: solvers.bicgstab(A, b, monitor=mon(l, t)),
                     False),
        "cg_m": ("poisson", lambda l, t: solvers.cg_m(A, b, sigma, monitor=mon(l, t)),
                 True),
        "bicgstab_m": ("poisson", lambda l, t: solvers.bicgstab_m(
            A, b, sigma, monitor=mon(l, t)), True),
        # refine: 12 outer sweeps at rel-tol t, inner CG to 1e-3 in at most
        # l iterations (one sweep where t is 0, for the profile)
        "refine": ("poisson", lambda l, t: solvers.refine(
            A_csr, b, config=refine_cfg, inner_rtol=1e-3, inner=inner,
            inner_limit=l, monitor=mon(12 if t else 1, t)), False),
        "gmres(50)": ("nonsym", lambda l, t: solvers.gmres(
            N, b, restart=50, monitor=mon(l, t)), False),
        "bicgstab N": ("nonsym", lambda l, t: solvers.bicgstab(N, b, monitor=mon(l, t)),
                       False),
        "bicgstab N, M = diag": ("nonsym", lambda l, t: solvers.bicgstab(
            N, b, M=M, monitor=mon(l, t)), False),
        "bicg N": ("nonsym", lambda l, t: solvers.bicg(N, b, monitor=mon(l, t), At=Nt),
                   False),
    }


def krylov_ops(A, N, dia_impl=None, csr_config=None):
    """(A and A^T on the via_dia plan, N and N^T planned with csr_config
    (the CSR kernel by default) and N's diagonal preconditioner, or None
    where N is None, A) and the seconds each plan took (the transposes run
    on the matrix's device)."""
    from cusp_autotuned_tpu_torch import transpose
    from cusp_autotuned_tpu_torch.operators import make_linear_operator, planned_operator
    from cusp_autotuned_tpu_torch.ops.format_utils import extract_diagonal
    setup = {}

    def timed(key, build):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        setup[key] = time.perf_counter() - t0
        return out
    cfg = {"impl": "via_dia", **({"dia_impl": dia_impl} if dia_impl else {})}
    ops = (timed("poisson", lambda: planned_operator(A, cfg)),
           timed("poisson A^T", lambda: planned_operator(transpose(A), cfg)))
    if N is None:
        return ops + (None, None, None, A), setup
    d = extract_diagonal(N)
    return ops + (timed("nonsym", lambda: planned_operator(N, csr_config)),
                  timed("nonsym N^T", lambda: planned_operator(transpose(N), csr_config)),
                  make_linear_operator(lambda r: r / d, N.shape), A), setup


def krylov_phase(device, A, b):
    """The krylov path: the Krylov solvers and refine at full width on the
    cg.cu path's A and b (F32_JAX_REACH's also in f64) and on a
    non-symmetric 1M-row matrix, then each solver's kernel operator against
    its plain one at 100x100 and 10,000 rows, and the six solvers with
    mesh= against their unsharded solves.  Returns the path's launch
    counts."""
    from cusp_autotuned_tpu_torch import gallery, parallel, solvers
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    N = nonsym_csr(A.num_rows, NONSYM_SEED, device)
    log(f"krylov: non-symmetric matrix (tests/test_krylov.py's recipe, seed "
        f"{NONSYM_SEED}): {N.num_rows} rows, nnz {N.nnz}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    A64 = dataclasses.replace(A, val=A.val.double())
    b64 = b.double()
    sigma = torch.tensor(KRYLOV_SIGMA, dtype=b.dtype, device=device)
    ops, setup = krylov_ops(A, N)
    ops64, setup64 = krylov_ops(A64, None)
    log("krylov: set-up s (the plans; A^T and N^T transposed on the card): "
        + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f"; f64: poisson {setup64['poisson']:.3f}")
    inner_runs = []

    def inner(A_lo, r, **kw):                   # refine's inner CG, recorded
        x, m = solvers.cg(A_lo, r, **kw)
        inner_runs.append((A_lo, m.iteration_count()))
        return x, m
    solves = krylov_solves(ops, b, sigma, {"impl": "binned"}, inner)
    solves.update({f"{k} f64": ("poisson f64", call, shifted) for k, (_, call, shifted)
                   in krylov_solves(ops64, b64, sigma.double(), {"impl": "binned"},
                                    inner).items()
                   if k in F32_JAX_REACH})
    rhs = {"poisson": b, "nonsym": b, "poisson f64": b64}
    check = {"poisson": planned_operator(A), "nonsym": ops[2],
             "poisson f64": planned_operator(A64)}
    for _, call, _ in solves.values():          # warm-up: cuBLAS, allocator
        call(2, 0.0)

    reset_counts()
    rows = {}
    for label, (problem, call, shifted) in solves.items():
        inner_runs.clear()
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, mon = call(2000, 1e-5)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        used = {k: v - before[k] for k, v in read_counts().items() if v > before[k]}
        its = mon.iteration_count()
        rel = mon.residual_norm() / mon.b_norm
        true = true_residual(check[problem], x, rhs[problem],
                             sigma.to(x.dtype) if shifted else None)
        inner_its = sum(n for _, n in inner_runs)
        refine = label.startswith("refine")
        walked = inner_its if refine else its
        plan = {"bicg": "poisson A^T", "bicg N": "nonsym N^T"}.get(
            label, problem.split()[0])
        reach = F32_JAX_REACH.get(label)
        rows[label] = (walked, solve_s, used)
        route = ("the CSR kernel outside, bf16 binned inside" if refine else
                 "via_dia" if problem.startswith("poisson") else "CSR kernel")
        log(f"krylov: {label} on {problem} ({route}), rtol 1e-5, limit "
            f"{12 if refine else 2000}: {its} iterations"
            f"{f' ({inner_its} inner)' if refine else ''}, converged "
            f"{mon.converged()}, relative residual {rel:.3e} (true {true:.3e}), "
            + ("set-up in the solve (refine plans its operators)" if refine else
               f"set-up {(setup64 if 'f64' in problem else setup)[plan]:.3f} s")
            + f", solve {solve_s:.3f} s, {1e3 * solve_s / max(walked, 1):.4f} "
            f"ms/iteration; launches {used}"
            + ("" if reach is None else f"; the JAX package in f32: relative "
               f"residual {reach[0]:.4e}, x finite {reach[1]}; held to the bar "
               f"in f64 below"))
        if x.shape[-1] != A.num_rows or (
                (reach is None or reach[1]) and not torch.isfinite(x).all()):
            raise RuntimeError(f"krylov: {label}: x is not finite or not of shape n")
        if reach is None and not (np.isfinite(rel) and rel < 1e-2 and np.isfinite(true)):
            raise RuntimeError(f"krylov: {label}: relative residual {rel} (true "
                               f"{true}) is not finite and below 1e-2")
        if reach is not None and reach[0] < 1 and not rel <= STALL_SLACK * reach[0]:
            raise RuntimeError(f"krylov: {label}: relative residual {rel} above "
                               f"{STALL_SLACK} times the JAX package's {reach[0]}")
        kernel = ("binned_spmv" if refine else
                  "dia_spmv" if problem.startswith("poisson") else "csr_spmv")
        if used.get(kernel, 0) < walked:
            raise RuntimeError(f"krylov: {label}: {kernel} launched "
                               f"{used.get(kernel, 0)} times in {walked} iterations")
        if refine:
            plans = {(op.impl, op.arrays["val"].dtype) for op, _ in inner_runs}
            if plans != {("binned", torch.bfloat16)}:
                raise RuntimeError(f"krylov: refine's inner plans are {plans}")
    launches = read_counts()
    log(f"krylov: full-width solves in {time.perf_counter() - t_path:.1f} s; "
        f"launches {launches}")

    # an iteration's device time, kernels and launch calls (torch.profiler over
    # a solve of KRYLOV_PROFILE_ITS iterations at rtol 0; refine: one sweep of
    # that many inner iterations), against its host time in the solve above
    for label, (problem, call, _) in solves.items():
        walked, solve_s, used = rows[label]
        dev, kern, host = launch_calls(lambda: call(KRYLOV_PROFILE_ITS, 0.0), 1)
        wall = 1e3 * solve_s / max(walked, 1)
        per = KRYLOV_PROFILE_ITS
        log(f"krylov: {label}: {wall:.4f} ms/iteration, {dev / per:.4f} ms device "
            f"({100 * dev / per / wall:.1f} % busy), {kern / per:.1f} kernels and "
            f"{host / per:.1f} launch calls an iteration; wrapper launches "
            + ", ".join(f"{k} {v / max(walked, 1):.2f}" for k, v in used.items())
            + " an iteration")

    # kernel operator against plain operator, and x against the scipy oracle,
    # on problems that converge: poisson5pt 100x100 and 10,000 rows of N's
    # recipe (CR in f64: at 100x100 it stagnates in f32 too; refine to
    # rel-tol 1e-4: its f32 residual b - A x floors at ~5.4e-5 there)
    P = gallery.poisson5pt(100, 100, format="csr", device=device)
    P64 = dataclasses.replace(P, val=P.val.double())
    Ns = nonsym_csr(10_000, NONSYM_SEED, device)
    bs = torch.as_tensor(np.random.RandomState(1).rand(P.num_rows),
                         dtype=torch.float32, device=device)
    found = {}
    for kind, dia_impl, csr_config, refine_cfg in (
            ("kernel", "cuda", None, {"impl": "binned"}),
            ("plain", "slices", {"impl": "segsum"},
             {"impl": "via_dia", "dia_impl": "slices"})):
        small = krylov_solves(krylov_ops(P, Ns, dia_impl, csr_config)[0], bs,
                              sigma, refine_cfg, solvers.cg)
        small.update({k: (problem, call, shifted) for k, (problem, call, shifted) in
                      krylov_solves(krylov_ops(P64, None, dia_impl)[0],
                                    bs.double(), sigma.double(), refine_cfg,
                                    solvers.cg).items()
                      if k == "cr"})
        for label, (problem, call, shifted) in small.items():
            x, mon = call(2000, 1e-4 if label == "refine" else 1e-5)
            res = oracle_residual(P if problem == "poisson" else Ns, x,
                                  bs.to(x.dtype), sigma if shifted else None)
            found.setdefault(label, {})[kind] = (mon.iteration_count(),
                                                 mon.converged(), res)
    for label, out in found.items():
        (ik, ck, rk), (ip, cp, rp) = out["kernel"], out["plain"]
        log(f"krylov: {label}{' (f64)' if label == 'cr' else ''} at "
            f"100x100 / 10,000 rows (iterations, converged, oracle residual): "
            f"kernel {out['kernel']}, plain {out['plain']}")
        if not (ck and cp and abs(ik - ip) <= 2 and rk < 1e-2 and rp < 1e-2):
            raise RuntimeError(f"krylov: {label}: the kernel and plain solves disagree")

    # mesh=: the six solvers at __graft_entry__.py's multichip input on a mesh
    # of MESH_ENTRIES entries of the one card, against their unsharded solves
    mesh = parallel.make_row_mesh([device] * MESH_ENTRIES)
    G = gallery.poisson5pt(16, 64, format="csr", device=device)
    bg = torch.ones(G.num_rows, device=device)
    mesh_calls = {
        "bicg": lambda **m: solvers.bicg(G, bg, **m),
        "gmres": lambda **m: solvers.gmres(G, bg, restart=20, **m),
        "cr": lambda **m: solvers.cr(G, bg, **m),
        "bicgstab": lambda **m: solvers.bicgstab(G, bg, **m),
        "cg_m": lambda **m: solvers.cg_m(G, bg, sigma, monitor=Monitor(bg, 80, 1e-6), **m),
        "bicgstab_m": lambda **m: solvers.bicgstab_m(G, bg, sigma,
                                                     monitor=Monitor(bg, 80, 1e-6), **m),
    }
    for name, call in mesh_calls.items():
        x1, m1 = call()
        xm, mm = call(mesh=mesh)
        log(f"krylov: {name}(mesh=) on poisson5pt(16, 64) f32, b = 1: "
            f"{mm.iteration_count()} iterations, unsharded {m1.iteration_count()} "
            f"(the JAX package on the CPU: {JAX_MESH_COUNTS[name]}), converged "
            f"{mm.converged()}, x against the unsharded {rel_diff(xm, x1):.2e}")
        if mm.iteration_count() != m1.iteration_count() or not mm.converged() \
                or not torch.isfinite(xm).all():
            raise RuntimeError(f"krylov: {name}(mesh=) differs from the unsharded solve")
        if abs(mm.iteration_count() - JAX_MESH_COUNTS[name]) > MESH_JAX_SLACK.get(name, 1):
            raise RuntimeError(f"krylov: {name}(mesh=) takes {mm.iteration_count()} "
                               f"iterations, the JAX package {JAX_MESH_COUNTS[name]}")
    log(f"krylov: path in {time.perf_counter() - t_path:.1f} s")
    return launches

# the graph path: the JAX package's AMG-CG count with the MIS aggregation
# and the Gauss-Seidel smoother at 150x150 f64 (amg_phase's b and rel-tol
# 1e-10), taken on the CPU with smoothed_aggregation(A, aggregator='mis',
# smoother='gauss_seidel'); the kernels the path must launch; the seed of
# its random symmetric permutations; and the shifted strip that rcm_dia
# serves (RCM of a 2-D grid leaves ~2n + 1 distinct diagonals, which the
# DIA fill guard refuses; of a strip four vertices wide, nine)
JAX_MIS_GS_150_ITERATIONS = 22
GRAPH_KERNELS = ("dia_spmv", "csr_spmv")
SCRAMBLE_SEED = 11
STRIP_WIDTH, STRIP_SHIFT = 4, 0.5
GRAPH_RTOL = 1e-5                    # GS, SOR and AINV applies, f32
NONSYM_AINV_ROWS = 100_000           # the non-symmetric AINV's instance


def scrambled(S, seed):
    """(P S P^T for a seeded random permutation p, p), scipy CSR."""
    p = np.random.RandomState(seed).permutation(S.shape[0])
    return S.tocsr()[p][:, p].tocsr(), p


def bandwidth(S):
    S = S.tocoo()
    return int(np.abs(S.row.astype(np.int64) - S.col).max())


def shifted_strip(rows, device):
    """poisson5pt(STRIP_WIDTH, rows / STRIP_WIDTH) + STRIP_SHIFT I in f32,
    and the same scrambled by SCRAMBLE_SEED: (strip, scrambled, p)."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
    S = to_scipy(gallery.poisson5pt(STRIP_WIDTH, rows // STRIP_WIDTH, format="csr",
                                    device="cpu"))
    S = (S + STRIP_SHIFT * sp.eye(S.shape[0], dtype=np.float32)).tocsr()
    Ss, p = scrambled(S, SCRAMBLE_SEED)
    return (from_scipy(S, "csr", dtype=torch.float32, device=device),
            from_scipy(Ss, "csr", dtype=torch.float32, device=device), p)


def unit_pattern(G):
    """G's off-diagonal pattern with unit values, planned on the plain
    path (segsum)."""
    from cusp_autotuned_tpu_torch.graph.traversal import strip_diagonal
    from cusp_autotuned_tpu_torch.operators import planned_operator
    C = strip_diagonal(G)
    C = dataclasses.replace(C, val=(C.row < C.num_rows).to(torch.float32))
    return planned_operator(C, {"impl": "segsum"}), C


def check_mis(name, G, stencil, k):
    """The stencil is an MIS(k) of G: no two selected vertices within k
    hops, every vertex within k hops of one; by plain SpMVs on the card."""
    op, _ = unit_pattern(G)
    s = stencil.to(torch.float32)
    y1 = op(s)
    if k == 1:
        clash, cover = s * y1, s + y1
    else:
        y2 = op(y1)                      # holds deg(v) s[v], the walks v-u-v
        deg = op(torch.ones_like(s))
        clash, cover = s * (y1 + y2 - deg * s), s + y1 + y2
    if float(clash.sum()) != 0 or not bool((cover > 0).all()):
        raise RuntimeError(f"graph: {name}: the MIS({k}) stencil is not "
                           f"independent and maximal")


def check_coloring(name, G, colors):
    _, C = unit_pattern(G)
    row, col = C.row[:C.nnz].long(), C.col[:C.nnz].long()
    if bool((colors[row] == colors[col]).any()) or bool((colors < 0).any()):
        raise RuntimeError(f"graph: {name}: an edge joins two vertices of one colour")


def graph_parts(device, A, b, clock):
    """The graph path's runs (traversal, reordering, AMG-CG with MIS and
    Gauss-Seidel or SOR, AINV); returns nothing, raises on a failed check."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu_torch import gallery, graph, precond, solvers
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops import blas
    from cusp_autotuned_tpu_torch.precond import smoothed_aggregation
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
    from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException

    n = A.num_rows
    nx = 1000
    v = torch.arange(n, device=device)

    # traversal on the cg.cu A
    levels = graph.breadth_first_search(A, 0)
    if not torch.equal(levels, (v // nx + v % nx).to(torch.int32)):
        raise RuntimeError("graph: the BFS levels are not the grid's hop distances")
    pred = graph.breadth_first_search(A, 0, mark_levels=False).long()
    step = v - pred
    up = (levels[pred] == levels - 1) & (((step == 1) & (v % nx != 0)) | (step == nx))
    if int(pred[0]) != 0 or not bool(up[1:].all()):
        raise RuntimeError("graph: a BFS predecessor is no neighbour one level up")
    count, _ = graph.connected_components(A)
    half = to_scipy(gallery.poisson5pt(nx, n // nx // 2, format="csr", device="cpu"))
    pair = from_scipy(sp.block_diag([half, half]).tocsr(), "csr", device=device)
    count2, labels2 = graph.connected_components(pair)
    split = (labels2[: n // 2] == labels2[0]).all() & (labels2[n // 2:] == labels2[-1]).all()
    if count != 1 or count2 != 2 or not bool(split) or int(labels2[0]) == int(labels2[-1]):
        raise RuntimeError(f"graph: components {count} and {count2}, not 1 and 2")
    log(f"graph: poisson5pt 1000x1000 f32: BFS levels from vertex 0 (the corner "
        f"at level {int(levels[-1])}, {int(levels.max()) + 1} levels, each a "
        f"CSR-kernel SpMV of the pattern), predecessors each a neighbour one level up; connected_components "
        f"{count}, {count2} on a block-diagonal pair of poisson5pt(1000, 500)")
    clock("BFS and components")
    for k in (1, 2):
        found, stencil = graph.maximal_independent_set(A, k=k)
        check_mis(f"poisson5pt 1000x1000 MIS({k})", A, stencil, k)
        log(f"graph: MIS({k}): {found} vertices, independent and maximal")
    ncolors, colors = graph.vertex_coloring(A)
    check_coloring("poisson5pt 1000x1000", A, colors)
    coord = torch.stack([v % nx, v // nx], 1).to(torch.float64)
    parts = graph.hilbert_curve(coord, 4)
    sizes = torch.bincount(parts.long(), minlength=4)
    if parts.device != coord.device or int(sizes.max() - sizes.min()) > 1:
        raise RuntimeError(f"graph: hilbert_curve part sizes {sizes.tolist()}")
    log(f"graph: vertex_coloring: {ncolors} colours, no edge inside one; "
        f"hilbert_curve of the grid's coordinates into 4 parts of "
        f"{sizes.tolist()} vertices")
    clock("MIS, colouring and Hilbert")

    # reordering: RCM of the scrambled cg.cu A, and rcm_dia where it serves
    S = to_scipy(A).tocsr()
    Ss, _ = scrambled(S, SCRAMBLE_SEED)
    As = from_scipy(Ss, "csr", device=device)
    t0 = time.perf_counter()
    P = graph.symmetric_rcm(As)
    rcm_s = time.perf_counter() - t0
    perm = P.perm.cpu().numpy()
    R = Ss[perm][:, perm].tocoo()
    offsets = np.unique(R.col.astype(np.int64) - R.row)
    try:
        planned_operator(As, {"impl": "rcm_dia"})
    except FormatConversionException as e:
        refused = str(e)
    else:
        raise RuntimeError("graph: rcm_dia planned the reordered grid's "
                           f"{offsets.size} diagonals past the DIA fill guard")
    log(f"graph: symmetric_rcm of poisson5pt 1000x1000 under a random symmetric "
        f"permutation (seed {SCRAMBLE_SEED}) in {rcm_s:.3f} s: bandwidth "
        f"{bandwidth(Ss)} before, {bandwidth(R)} after ({bandwidth(S)} unscrambled); "
        f"the reordered grid has {offsets.size} distinct diagonals, and rcm_dia "
        f"is refused ({refused})")
    del As, R
    strip, strip_s, p = shifted_strip(n, device)
    t0 = time.perf_counter()
    rcm_op = planned_operator(strip_s, {"impl": "rcm_dia"})
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    bs = b[torch.as_tensor(p, device=device)]
    _, mon_rcm, rcm_solve = solve(rcm_op, bs)
    _, mon_dia, dia_solve = solve(planned_operator(strip, {"impl": "via_dia"}), b)
    its_rcm, its_dia = mon_rcm.iteration_count(), mon_dia.iteration_count()
    log(f"graph: rcm_dia on poisson5pt({STRIP_WIDTH}, {n // STRIP_WIDTH}) + "
        f"{STRIP_SHIFT} I f32 under the same permutation (bandwidth "
        f"{bandwidth(to_scipy(strip_s))}): planned in {plan_s:.3f} s ({rcm_op.impl}); "
        f"CG rtol 1e-5 through it {its_rcm} iterations ({rcm_solve:.3f} s), "
        f"via_dia on the unscrambled strip {its_dia} ({dia_solve:.3f} s)")
    if not (mon_rcm.converged() and mon_dia.converged() and abs(its_rcm - its_dia) <= 2):
        raise RuntimeError("graph: CG through rcm_dia and via_dia disagree")
    clock("reordering")

    # AMG-CG with the MIS aggregation, Gauss-Seidel or SOR smoothing
    x_true = torch.as_tensor(np.random.RandomState(0).rand(n), dtype=torch.float32,
                             device=device)
    bx = planned_operator(A, {"impl": "segsum"})(x_true)
    op = planned_operator(A, {"impl": "via_dia"})
    _, mon_plain, plain_s = solve(op, bx)
    plain_its = mon_plain.iteration_count()
    for smoother in ("gauss_seidel", "sor"):
        t0 = time.perf_counter()
        M = smoothed_aggregation(A, aggregator="mis", smoother=smoother,
                                 spmv_config={})
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        log(f"graph: smoothed_aggregation(poisson5pt 1000x1000 f32, aggregator='mis', "
            f"smoother='{smoother}', spmv_config={{}}) in {setup_s:.2f} s ("
            + ", ".join(f"{k} {s:.2f}" for k, s in M.setup_s.items()) + " s), colours "
            + str([lvl.smoother.relax.num_colors if smoother == "gauss_seidel"
                   else lvl.smoother.relax.gs.num_colors for lvl in M.levels]) + ":")
        describe_levels(M)
        cycle_ms = median_ms(lambda: M(bx), samples=3, per_sample=5)
        cycle_dev, kernels, launches = launch_calls(lambda: M(bx), 3)
        t0 = time.perf_counter()
        x, mon = solvers.cg(op, bx, M=M, monitor=Monitor(bx, 2000, 1e-5))
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        its = mon.iteration_count()
        true_res = float(blas.nrm2(bx - planned_operator(A)(x)) / blas.nrm2(bx))
        log(f"graph: one V-cycle {cycle_ms:.4f} ms a call, {cycle_dev:.4f} ms device "
            f"({100 * cycle_dev / cycle_ms:.1f} % busy), {kernels:.1f} kernels "
            f"recorded and {launches:.1f} launch calls a cycle; AMG-CG (via_dia, "
            f"rtol 1e-5) {its} iterations, converged {mon.converged()}, true "
            f"relative residual {true_res:.3e} (CSR kernel), solve {solve_s:.3f} s, "
            f"{1e3 * solve_s / max(its, 1):.4f} ms/iteration; plain CG on the same "
            f"b {plain_its} iterations, {plain_s:.3f} s")
        if not (mon.converged() and true_res < 1e-4 and its < plain_its / 2):
            raise RuntimeError(f"graph: AMG-CG with {smoother} took {its} iterations "
                               f"(plain CG {plain_its}), true residual {true_res}")
        del M, x
    clock("AMG-CG, MIS and Gauss-Seidel or SOR")
    A150 = gallery.poisson5pt(150, 150, format="csr", dtype=torch.float64,
                              device=device)
    b150 = torch.as_tensor(1.01 * np.random.RandomState(7).rand(A150.num_rows)
                           + 0.5, device=device)
    M150 = smoothed_aggregation(A150, aggregator="mis", smoother="gauss_seidel")
    _, mon150 = solvers.cg(A150, b150, M=M150, monitor=Monitor(b150, 100, 1e-10))
    its150 = mon150.iteration_count()
    log(f"graph: poisson5pt 150x150 f64, aggregator='mis', smoother='gauss_seidel', "
        f"rtol 1e-10: {its150} iterations (the JAX package: "
        f"{JAX_MIS_GS_150_ITERATIONS}), converged {mon150.converged()}")
    if its150 != JAX_MIS_GS_150_ITERATIONS or not mon150.converged():
        raise RuntimeError(f"graph: the 150x150 MIS/GS solve took {its150} "
                           f"iterations, not {JAX_MIS_GS_150_ITERATIONS}")
    clock("150x150 against the JAX count")

    # AINV: CG on the cg.cu system, BiCGstab on the krylov path's
    # non-symmetric recipe at NONSYM_AINV_ROWS rows (its host factorisation
    # took 43-70 s at 1M rows, PERF.md).  Each apply of M is two CSR-kernel
    # SpMVs (Z and W^T) and a scale, so M adds at least 2 CSR launches an
    # iteration: one apply is counted alone, and the solve's applies are
    # counted
    N = nonsym_csr(NONSYM_AINV_ROWS, NONSYM_SEED, device)
    opN = planned_operator(N)
    bN = torch.as_tensor(np.random.RandomState(0).rand(N.num_rows),
                         dtype=torch.float32, device=device)
    plain = {}
    for label, factory, solver, opx, Ax, rhs in (
            ("bridson_ainv", precond.bridson_ainv, solvers.cg, op, A, b),
            ("scaled_bridson_ainv", precond.scaled_bridson_ainv, solvers.cg, op, A, b),
            ("nonsym_bridson_ainv", precond.nonsym_bridson_ainv, solvers.bicgstab,
             opN, N, bN)):
        t0 = time.perf_counter()
        M = factory(Ax, 0.1)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        before = read_counts()["csr_spmv"]
        M(rhs)
        per_apply = read_counts()["csr_spmv"] - before
        if solver not in plain:
            t0 = time.perf_counter()
            _, mon = solver(opx, rhs, monitor=Monitor(rhs, 2000, 1e-5))
            torch.cuda.synchronize()
            plain[solver] = (mon.iteration_count(), time.perf_counter() - t0)
        applies = []

        def counted(r):
            applies.append(1)
            return M(r)
        t0 = time.perf_counter()
        _, mon = solver(opx, rhs, M=counted, monitor=Monitor(rhs, 2000, 1e-5))
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        its, (plain_its, plain_s) = mon.iteration_count(), plain[solver]
        log(f"graph: {solver.__name__} with {label}"
            f"({f'N ({N.num_rows} rows)' if Ax is N else 'A'}, 0.1) "
            f"(Z {M.z.nnz} entries, W^T {M.wt.nnz}, set-up {setup_s:.2f} s): {its} "
            f"iterations, converged {mon.converged()}, solve {solve_s:.3f} s, "
            f"{len(applies)} applies of M, {per_apply} CSR-kernel launches an apply; "
            f"without M {plain_its} iterations, {plain_s:.3f} s")
        if not (mon.converged() and its < plain_its and per_apply == 2
                and len(applies) >= its):
            raise RuntimeError(f"graph: {label} does not cut the iterations or "
                               f"does not run M through the CSR kernel")
        del M
    clock("AINV")


def graph_against_plain(device):
    """Each algorithm on a planned operator, on the card, against the plain
    path: BFS through the CSR kernel against the pattern's container (plain
    PyTorch on the card) and the CPU; components, MIS and colours on the
    card against the CPU; Gauss-Seidel and SOR sweeps through the CSR and
    DIA kernels, and AINV applies through the CSR kernel, against the
    containers' plain products; and the rcm_dia SpMV (dia_spmv) against its
    plain DIA impl, at 100x100 and 10,000 rows, and at full width."""
    from unittest import mock
    from cusp_autotuned_tpu_torch import gallery, graph, precond, relaxation
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
    from cusp_autotuned_tpu_torch.operators import planned_operator

    def plain_solve_operator(A):
        return A

    def same(label, got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise RuntimeError(f"graph: {label}: the planned and plain runs differ")

    def close(label, got, want, rtol=GRAPH_RTOL):
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= rtol:
            raise RuntimeError(f"graph: {label}: relative error {err:.3e} > {rtol}")
        return err

    P100 = gallery.poisson5pt(100, 100, format="csr", device=device)
    N10k = nonsym_csr(10_000, NONSYM_SEED, device)
    Sn = to_scipy(N10k)
    R10k = from_scipy((Sn + Sn.T).tocsr(), "csr", device=device)
    rng = np.random.RandomState(2)
    worst = 0.0
    for name, G in (("poisson5pt 100x100", P100), ("10,000 rows, random symmetric", R10k)):
        Gc = G.to("cpu")
        for mark in (True, False):
            got = graph.breadth_first_search(G, 0, mark_levels=mark)
            with mock.patch("cusp_autotuned_tpu_torch.operators.solve_operator",
                            plain_solve_operator):
                same(f"{name} BFS", got, graph.breadth_first_search(G, 0, mark_levels=mark))
            same(f"{name} BFS (CPU)", got, graph.breadth_first_search(Gc, 0, mark_levels=mark))
        same(f"{name} components", graph.connected_components(G)[1],
             graph.connected_components(Gc)[1])
        for k in (1, 2):
            same(f"{name} MIS({k})", graph.maximal_independent_set(G, k)[1],
                 graph.maximal_independent_set(Gc, k)[1])
        same(f"{name} colours", graph.vertex_coloring(G)[1], graph.vertex_coloring(Gc)[1])
        b = torch.as_tensor(rng.randn(G.num_rows), dtype=torch.float32, device=device)
        x0 = torch.as_tensor(rng.randn(G.num_rows), dtype=torch.float32, device=device)
        gs, so = relaxation.gauss_seidel(G), relaxation.sor(G, omega=1.2)
        kernels = [planned_operator(G)] + ([planned_operator(G, {"impl": "via_dia"})]
                                           if G is P100 else [])
        for op in kernels:
            for direction in (relaxation.FORWARD, relaxation.BACKWARD,
                              relaxation.SYMMETRIC):
                worst = max(worst, close(f"{name} GS {direction} ({op.impl})",
                                         gs(op, b, x0, direction), gs(G, b, x0, direction)))
            worst = max(worst, close(f"{name} SOR ({op.impl})", so(op, b, x0),
                                     so(G, b, x0)))
    for label, M in (("bridson_ainv", precond.bridson_ainv(P100, 0.1)),
                     ("scaled_bridson_ainv", precond.scaled_bridson_ainv(P100, 0.1)),
                     ("nonsym_bridson_ainv", precond.nonsym_bridson_ainv(N10k, 0.1))):
        r = torch.as_tensor(rng.randn(M.shape[0]), dtype=torch.float32, device=device)
        if M.z_op.impl != "cuda" or M.wt_op.impl != "cuda":
            raise RuntimeError(f"graph: {label}'s factors are not on the CSR kernel")
        worst = max(worst, close(f"{label} apply", M(r),
                                 dataclasses.replace(M, z_op=M.z, wt_op=M.wt)(r)))
    rcm_err = []
    for rows in (10_000, 1_000_000):
        _, strip_s, _ = shifted_strip(rows, device)
        x = seeded_x(rows, 4, device)
        before = read_counts()["dia_spmv"]
        y = planned_operator(strip_s, {"impl": "rcm_dia"})(x)
        if read_counts()["dia_spmv"] != before + 1:
            raise RuntimeError("graph: the rcm_dia SpMV did not launch dia_spmv once")
        y_plain = planned_operator(strip_s, {"impl": "rcm_dia", "dia_impl": "slices"})(x)
        rcm_err.append(check_mode(f"graph: rcm_dia SpMV, {rows} rows", y, y_plain,
                                  DIA_RTOL, DIA_ATOL))
    log(f"graph: kernel against plain at 100x100 and 10,000 rows: BFS levels and "
        f"predecessors, components, MIS(1), MIS(2) and colours equal exactly; GS "
        f"(three directions) and SOR sweeps through the CSR and DIA kernels and the "
        f"AINV applies through the CSR kernel within {worst:.2e} relative (rtol "
        f"{GRAPH_RTOL}); the rcm_dia SpMV through dia_spmv at 10,000 and 1,000,000 "
        f"rows max |diff| {rcm_err[0]:.2e}, {rcm_err[1]:.2e} (rtol {DIA_RTOL}, atol "
        f"{DIA_ATOL})")


def graph_phase(device, A, b):
    """The graph path on the cg.cu path's A and b, then its algorithms
    against the plain path; returns the path's launch counts."""
    t_path = time.perf_counter()
    seconds = {}
    mark = [time.perf_counter()]

    def clock(part):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[part] = now - mark[0]
        mark[0] = now

    reset_counts()
    graph_parts(device, A, b, clock)
    launches = read_counts()
    graph_against_plain(device)
    clock("kernel against plain")
    log("graph: seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; path in {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return launches


# the spgemm path: its tolerances and the kernels it must launch
SPGEMM_KERNELS = ("dia_spmv", "csr_spmv", "dia_spmm")
SPGEMM_RTOL = 1e-5                   # C x against A (A x), X^T A, RAP; f32
MINPLUS_RTOL = 1e-10                 # the 10,000-row f64 product, card vs CPU


def min_plus_10k(device, seed=5, n=10_000, density=3e-4):
    """tests/test_ops.py:266's recipe, a 10,000-row f64 matrix of density
    3e-4 plus I, drawn by numpy index draws (scipy's sp.random visits every
    one of the 10^8 cells), as a COO on `device`."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    rng = np.random.RandomState(seed)
    k = int(density * n * n)
    S = sp.coo_matrix((rng.rand(k), (rng.randint(0, n, k), rng.randint(0, n, k))),
                      shape=(n, n)) + sp.eye(n)
    return from_scipy(S.tocsr().astype(np.float64), "coo", device=device)


def timed_s(fn):
    """(fn(), host seconds to its end on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


def spgemm_phase(device, A):
    """The spgemm path on the cg.cu path's A; returns the path's launch
    counts.  Any failed check raises."""
    from cusp_autotuned_tpu_torch import (
        add, gallery, generalized_spgemm, multiply, transpose,
    )
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    from cusp_autotuned_tpu_torch.formats import csr_matrix
    from cusp_autotuned_tpu_torch.operators import planned_operator
    from cusp_autotuned_tpu_torch.ops import spgemm as SG
    from cusp_autotuned_tpu_torch.ops.format_utils import count_diagonals
    from cusp_autotuned_tpu_torch.precond import smoothed_aggregation
    from cusp_autotuned_tpu_torch.precond.aggregation.smooth import galerkin_product

    t_path = time.perf_counter()
    n = A.num_rows
    side = math.isqrt(n)                        # A is poisson5pt(side, side)
    small = gallery.poisson5pt(50, 50, format="csr", device=device)
    multiply(small, small)                      # warm-up: allocator, sort
    reset_counts()

    # C = A A: two slices and a merge, against scipy and a second call
    plan = SG.plan(A, A)
    slices = [last - first for _, _, first, last in plan.bounds]
    del plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    C, spgemm_s = timed_s(lambda: multiply(A, A))
    peak = torch.cuda.max_memory_allocated() - base
    again = [timed_s(lambda: multiply(A, A)) for _ in range(2)]
    repeat = all(torch.equal(getattr(C, f), getattr(C2, f))
                 for C2, _ in again for f in ("indptr", "col", "val", "row"))
    again_s = ", ".join(f"{t:.4f}" for _, t in again)
    del again
    S = to_scipy(A).tocsr()
    t0 = time.perf_counter()
    R = (S @ S).tocsr()
    scipy_s = time.perf_counter() - t0
    R.sort_indices()
    same_pattern = (np.array_equal(C.indptr.cpu().numpy(), R.indptr)
                    and np.array_equal(C.col[:C.nnz].cpu().numpy(), R.indices))
    same_bits = C.val[:C.nnz].cpu().numpy().tobytes() == R.data.tobytes()
    diagonals = count_diagonals(n, n, C.row[:C.nnz].cpu(), C.col[:C.nnz].cpu())
    dev_ms, kernels, calls = launch_calls(lambda: multiply(A, A), 1)
    by_kernel = {}
    for key, (ms, _) in device_kernels(lambda: multiply(A, A), 1).items():
        by_kernel[kernel_name(key)] = by_kernel.get(kernel_name(key), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    Ssp = sparse_csr(A)
    Ssp @ Ssp                                   # warm-up: cuSPARSE's workspace
    L, cusparse_s = timed_s(lambda: Ssp @ Ssp)
    library_nnz = L._nnz()
    del L, Ssp
    log(f"spgemm: C = A A, poisson5pt {side}x{side} CSR f32 ({A.nnz} entries): "
        f"{sum(slices)} expanded products in {len(slices)} slices {slices} "
        f"(MAX_WORKSPACE {SG.MAX_WORKSPACE}) and a merge; C {C.nnz} entries on "
        f"{diagonals} diagonals; SpGEMM {spgemm_s:.4f} s, again {again_s} s "
        f"(host clock after torch.cuda.synchronize); a product {dev_ms:.3f} ms of "
        f"device in {kernels:.0f} kernels and {calls:.0f} launch calls "
        f"(torch.profiler), the most device ms in "
        + ", ".join(f"{name} {ms:.3f}" for name, ms in top)
        + f"; peak device memory {peak / 2**20:.1f} MiB above the inputs; scipy "
        f"on the host {scipy_s:.4f} s; cuSPARSE (torch.sparse CSR @ CSR, yardstick)"
        f" {cusparse_s:.4f} s, {library_nnz} entries; pattern equal "
        f"to scipy's {same_pattern}, values bit for bit {same_bits}, a second call "
        f"bit for bit {repeat}")
    if not (same_pattern and same_bits and repeat and C.format == "csr"
            and C.device == A.device and len(slices) >= 2 and diagonals == 13):
        raise RuntimeError("spgemm: C = A A differs from scipy's, from a second "
                           "call, or ran in fewer than two slices")

    # C x through the hand kernels against A (A x) through A's via_dia plan
    x = seeded_x(n, 12, device)
    opA = planned_operator(A, {"impl": "via_dia"})
    before = read_counts()
    y_ref = opA(opA(x))
    y_dia = planned_operator(C, {"impl": "via_dia"})(x)
    y_csr = planned_operator(C)(x)
    after = read_counts()
    err_dia, err_csr = rel_max(y_dia, y_ref), rel_max(y_csr, y_ref)
    log(f"spgemm: C x through via_dia (dia_spmv, {diagonals} diagonals) and CSR "
        f"(csr_spmv) against A (A x) through A's via_dia plan: relative max |diff| "
        f"{err_dia:.3e} and {err_csr:.3e} (rtol {SPGEMM_RTOL}); launches dia_spmv "
        f"{after['dia_spmv'] - before['dia_spmv']}, csr_spmv "
        f"{after['csr_spmv'] - before['csr_spmv']}")
    if not (err_dia <= SPGEMM_RTOL and err_csr <= SPGEMM_RTOL
            and after["dia_spmv"] - before["dia_spmv"] == 3
            and after["csr_spmv"] - before["csr_spmv"] == 1):
        raise RuntimeError("spgemm: C x through the kernels differs from A (A x)")
    del C, y_ref, y_dia, y_csr

    # the Galerkin chain on the first level's prolongator
    M, setup_s = timed_s(lambda: smoothed_aggregation(A))
    P = M.levels[0].P
    del M
    Pt, transpose_s = timed_s(lambda: transpose(P))
    Ac, chain_s = timed_s(lambda: multiply(Pt, multiply(A, P)))
    t0 = time.perf_counter()
    Ac_host = to_scipy(galerkin_product(Pt, A, P)).tocsr()
    host_s = time.perf_counter() - t0
    Ac_card = to_scipy(Ac).tocsr()
    rap_err = abs(Ac_card - Ac_host).max() / abs(Ac_host).max()
    log(f"spgemm: Galerkin chain P^T (A P) on smoothed_aggregation(A)'s first "
        f"prolongator ({P.num_rows} x {P.num_cols}, {P.nnz} entries; set-up "
        f"{setup_s:.2f} s, P^T {transpose_s:.2f} s on the host): A_c {Ac.nnz} entries "
        f"in {chain_s:.4f} s on the card, the host's galerkin_product {Ac_host.nnz} "
        f"entries in {host_s:.3f} s; relative max |diff| {rap_err:.3e} (rtol "
        f"{SPGEMM_RTOL})")
    if not rap_err <= SPGEMM_RTOL or Ac.device != A.device:
        raise RuntimeError(f"spgemm: the Galerkin chain differs from the host's by "
                           f"{rap_err}")
    del P, Pt, Ac, Ac_host, Ac_card

    # min-plus on grid2d(1000, 1000) with a zero diagonal, and the 10,000-row
    # f64 recipe against the CPU
    G = gallery.grid2d(side, side, device=device)
    G = add(G, csr_matrix(np.arange(n + 1), np.arange(n), np.zeros(n, np.float32),
                          (n, n), device=device))
    minplus_slices = len(SG.plan(G, G).bounds)
    D, minplus_s = timed_s(lambda: generalized_spgemm(G, G, None, torch.add, min))
    r, c = D.row[:D.nnz].long(), D.col[:D.nnz].long()
    manhattan = torch.equal(D.val[:D.nnz],
                            ((r % side - c % side).abs() + (r // side - c // side).abs())
                            .to(D.dtype))
    pattern = np.array_equal(D.indptr.cpu().numpy(), R.indptr) and np.array_equal(
        D.col[:D.nnz].cpu().numpy(), R.indices)
    del D, G, r, c, R
    H = min_plus_10k(device)
    Hc, h_s = timed_s(lambda: generalized_spgemm(H, H, None, lambda a, b: a + b, min))
    Hh = generalized_spgemm(H.to("cpu"), H.to("cpu"), None, lambda a, b: a + b, min)
    h_pattern = (Hc.nnz == Hh.nnz and torch.equal(Hc.row.cpu(), Hh.row)
                 and torch.equal(Hc.col.cpu(), Hh.col))
    h_err = rel_max(Hc.val.cpu(), Hh.val)
    log(f"spgemm: min-plus on grid2d({side}, {side}) + 0 I: {minplus_slices} slices, "
        f"{minplus_s:.4f} s; every entry the Manhattan distance {manhattan}, the "
        f"pattern that of A A {pattern}; the 10,000-row f64 recipe ({H.nnz} entries): "
        f"C {Hc.nnz} entries in {h_s:.4f} s, pattern equal to the CPU's {h_pattern}, "
        f"relative max |diff| {h_err:.3e} (rtol {MINPLUS_RTOL})")
    if not (manhattan and pattern and minplus_slices >= 2 and h_pattern
            and h_err <= MINPLUS_RTOL):
        raise RuntimeError("spgemm: a semiring product is wrong")

    # dense x sparse against (A^T X)^T through the via_dia plan (dia_spmm)
    X = torch.as_tensor(np.random.RandomState(13).randn(n, 16), dtype=torch.float32,
                        device=device)
    Y, dense_s = timed_s(lambda: multiply(X.T, A))
    before = read_counts()["dia_spmm"]
    Y_ref = planned_operator(transpose(A), {"impl": "via_dia"})(X)
    spmm_launches = read_counts()["dia_spmm"] - before
    err = rel_max(Y.T, Y_ref)
    log(f"spgemm: X^T A for X of {n} x 16 in {dense_s:.3f} s, against (A^T X)^T "
        f"through the via_dia plan ({spmm_launches} dia_spmm launch): relative max "
        f"|diff| {err:.3e} (rtol {SPGEMM_RTOL})")
    if not (Y.shape == (16, n) and err <= SPGEMM_RTOL and spmm_launches == 1):
        raise RuntimeError("spgemm: dense x sparse differs from (A^T X)^T")

    launches = read_counts()
    log(f"spgemm: path in {time.perf_counter() - t_path:.1f} s; launches {launches}")
    return launches


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

    t0 = time.perf_counter()
    results = autotune.tune(A, x, reference_computation=reference_spmv)
    log(f"autotune: tune({name}, {A.format}, x {tuple(x.shape)}): "
        f"{len(results)} configurations in {time.perf_counter() - t0:.1f} s")
    return walked(name, A, x, results, need)


def walked(name, A, x, results, need=("binned", "colsort", "cuda"),
           against_profiler=False):
    """walk()'s checks and lines on a walk's results.  against_profiler:
    each leader's device time through device_time.device_us_per_call (the
    median of a call's kernels over PER_SAMPLE calls) must agree with
    device_ms on the same call to LEADER_AGREEMENT, in one of three
    readings."""
    from cusp_autotuned_tpu_torch import autotune
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
    from cusp_autotuned_tpu_torch.utils.device_time import device_us_per_call

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
        readings = []
        for _ in range(3 if against_profiler else 1):
            t, seen, kernels = device_ms(lambda: fn(x))
            if not against_profiler:
                break
            us = device_us_per_call(fn, x, reps=PER_SAMPLE)
            readings.append((t, us))
            if t is not None and us is not None and \
                    abs(us / 1e3 - t) <= LEADER_AGREEMENT * t:
                break
        else:
            raise RuntimeError(f"autotune: {name}: device_us_per_call and device_ms "
                               f"disagree past {LEADER_AGREEMENT:.0%} on "
                               f"{r.configuration}: (ms, us) {readings}")
        log(f"    leader {r.duration_ms:.4f} ms tuned, {describe_device(t, seen)} ("
            + ", ".join(f"{kernel_name(k)} {ms:.4f} ms x{n:g} recorded"
                        for k, (ms, n) in kernels.items())
            + f"): {r.configuration}"
            + (f"; device_us_per_call {us / 1e3:.4f} ms ({len(readings)} "
               f"reading{'s' if len(readings) > 1 else ''})" if against_profiler else ""))
    return results


def cli_walk(name, A):
    """The walk of `name`, poisson5pt 1000x1000 CSR f32, through the offline
    CLI's main(["poisson5pt:1000", "--json"]) in this process.  Its JSON
    line must cover the space (configs == space_size, no coverage note)
    with no cusparse result, and its winner must match the oracle at the
    tuner's f32 bar; then walk()'s checks, the leaders' device times held
    to device_us_per_call.  Returns the results and the CLI's x."""
    from cusp_autotuned_tpu_torch import autotune
    from cusp_autotuned_tpu_torch.autotune import __main__ as cli
    from cusp_autotuned_tpu_torch.autotune.space import config_key
    from cusp_autotuned_tpu_torch.autotune.tuner import matrix_signature
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    argv = ["poisson5pt:1000", "--json"]
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(argv)
    walk_s = time.perf_counter() - t0
    tuner = autotune.get_tuner()
    tuner.log_fn = None                  # the CLI's progress sink
    out = json.loads(stdout.getvalue())
    log(f"autotune: python -m cusp_autotuned_tpu_torch.autotune {' '.join(argv)} "
        f"in this process: rc {rc}, {out['configs']} of {out['space_size']} "
        f"configurations, {out['ok']} Ok, in {walk_s:.1f} s; channel "
        f"{out['channel']}; best {out['best']}; keys {sorted(out)}")
    # the CLI's x: RandomState(0).randn in the matrix's dtype
    x = torch.from_numpy(np.random.RandomState(0).randn(A.num_cols)
                         .astype(np.float32)).to(A.device)
    store = tuner.results[matrix_signature(A, x)]
    results = [store[config_key(r["config"])] for r in out["results"]]
    if rc != 0 or out["configs"] != out["space_size"] or "coverage" in out:
        raise RuntimeError(f"autotune: the CLI's walk of {name} did not cover the "
                           f"space: rc {rc}, {out['configs']} of {out['space_size']}")
    if any(r["config"]["impl"] == "cusparse" for r in out["results"]):
        raise RuntimeError("autotune: the CLI walked the cusparse baseline")
    ref = reference_spmv(A, x)
    y = build_spmv(A, out["best"])(x).double().cpu().numpy()
    rel = np.linalg.norm(y - ref) / np.linalg.norm(ref)
    log(f"  the CLI's winner against the oracle: relative error {rel:.3e}")
    if not rel <= 1e-4:
        raise RuntimeError(f"autotune: the CLI's winner {out['best']} differs from "
                           f"the oracle by {rel:.3e}")
    return walked(name, A, x, results, against_profiler=True), x


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
    name = "poisson5pt 1000x1000 f32"
    results, x = cli_walk(name, A)
    model_line(name, A, x, results)
    name = "random 1M rows, skewed"
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

    # choose_format walks six formats, so it runs on a quarter of the grid
    A = gallery.poisson5pt(500, 500, format="csr", device=device)
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
    log(f"autotune: choose_format over {FORMATS} on poisson5pt 500x500 in "
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
    results = walk("poisson5pt 1000x1000 f32", A, X,
                   need=("binned", "colsort", "via_dia/cuda"))
    default_line("poisson5pt 1000x1000 f32", A, X, results)
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
    results = walk("random 1M rows, skewed", S, XS, need=("binned", "colsort"))
    default_line("random 1M rows, skewed", S, XS, results)
    del results
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


def against_leader(A, x, results, pick):
    """(pick ms, the walk's leader, leader ms): the configuration `pick`
    and the leader of the walk `results` timed again side by side (pick,
    leader, leader, pick) as the tuner times a configuration."""
    from cusp_autotuned_tpu_torch.autotune import Tuner
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    lead = min((r for r in results if r.is_valid()), key=lambda r: r.duration_ms)
    fns = {"pick": build_spmv(A, pick), "leader": build_spmv(A, lead.configuration)}
    t = Tuner()
    times = {"pick": [], "leader": []}
    for k in ("pick", "leader", "leader", "pick"):
        times[k].append(t._time_graph(fns[k], x))
    pick_ms, lead_ms = (statistics.median(times[k]) for k in ("pick", "leader"))
    return pick_ms, lead, lead_ms


def model_line(name, A, x, results):
    """The cost model's pick for A against the leader of the walk `results`,
    both timed again side by side; recorded in MODEL_LINES."""
    from cusp_autotuned_tpu_torch.autotune.cost_model import predict, recommend_config

    pick, us = recommend_config(A, x)
    pick_ms, lead, lead_ms = against_leader(A, x, results, pick)
    priced = {k: round(v["us"], 2) for k, v in predict(A, x).items() if "us" in v}
    MODEL_LINES.append((name, pick, pick_ms, lead.configuration, lead_ms))
    log(f"model: {name}: pick {pick} (predicted {us:.2f} us) {pick_ms:.4f} ms; "
        f"walk leader {label(lead.configuration)} {lead.duration_ms:.4f} ms in the "
        f"walk, {lead_ms:.4f} ms now; pick / leader {pick_ms / lead_ms:.3f}; "
        f"predicted us {priced}")


def default_line(name, A, x, results):
    """The untuned configuration (default_config: binned for a block x on a
    matrix that is not DIA) against the leader of the walk `results`, both
    timed again side by side."""
    from cusp_autotuned_tpu_torch.kernels.variants import default_config

    pick = default_config(A, x)
    pick_ms, lead, lead_ms = against_leader(A, x, results, pick)
    log(f"default: {name}, x {tuple(x.shape)}: untuned {pick} {pick_ms:.4f} ms; "
        f"walk leader {label(lead.configuration)} {lead.duration_ms:.4f} ms in the "
        f"walk, {lead_ms:.4f} ms now ({lead.configuration}); default / leader "
        f"{pick_ms / lead_ms:.3f}")


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
    from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
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
        # the SpMM band kernel runs the whole kernel's body: the same bits
        if (cols and not torch.equal(y_banded, y_whole)) or not bool(
                ((y_banded - y_whole).abs() <= BAND_RTOL * y_whole.abs()).all()):
            raise RuntimeError(f"{name}: the banded product differs from the "
                               f"unsharded DIA kernel's")
        if cols:
            band0, _, x_prep = spmv_tiles.band_plan(D, device, MESH_ENTRIES)
            cold_line(f"row 11: {name} band 0 of {MESH_ENTRIES} k={cols}", band0,
                      x_prep(x), k * band * 4 + (2 * band + span) * 4 * cols,
                      band_csr(A_csr, 0, band), library_x=x)
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
    # the JAX harness's floor kernel is a copy: Tensor.copy_ of the same
    # tile is one launch of the same bytes (the port's floor also scales)
    z = torch.empty_like(x)
    copy_ms = median_ms(lambda: z.copy_(x))
    copy_graph_ms = harness.graph_time_s(lambda: z.copy_(x), repeats=100,
                                         device=x.device) * 1e3
    log(f"  yardstick: Tensor.copy_ of the same tile {copy_ms:.4f} ms/call, "
        f"{copy_graph_ms:.5f} ms a launch in a graph's replay")
    del z

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
        "1e-4), shipped, rows=R, team=T and xtile equal to dia_spmm bit for bit:")
    # the shapes main() times, and k = 3 for the narrow team
    for grid, k in dia_spmm_probe.SHAPES:
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


def cli_subprocess(device):
    """python -m cusp_autotuned_tpu_torch.autotune in a process of its own, on
    a .mtx of poisson5pt 200x200 that io.write_matrix_market_file writes,
    with --choose-format, a budget that cuts the walk and --json: rc 0, the
    coverage note of the unwalked configurations, and best_format's plan
    against the oracle."""
    import tempfile
    from cusp_autotuned_tpu_torch import gallery, io as pio
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
    from cusp_autotuned_tpu_torch.ops.convert import convert

    A = gallery.poisson5pt(200, 200, format="csr", device=device)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "poisson5pt_200.mtx")
        pio.write_matrix_market_file(A, path)
        argv = [sys.executable, "-m", "cusp_autotuned_tpu_torch.autotune", path,
                "--choose-format", "--budget", str(CLI_BUDGET_S), "--json"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
    run_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"entry points: the CLI exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    note = out.get("coverage", {})
    log(f"entry points: python -m cusp_autotuned_tpu_torch.autotune <poisson5pt "
        f"200x200 .mtx> --choose-format --budget {CLI_BUDGET_S} --json: rc 0 in "
        f"{run_s:.1f} s (process start, walk and six format walks); "
        f"{out['configs']} of {out['space_size']} configurations walked, "
        f"{out['ok']} Ok, order {out.get('order')}; coverage {note}; best "
        f"{out['best']}; best_format {out['best_format']} "
        f"{out['best_format_config']}; {proc.stderr.count('[tune ')} progress lines "
        f"on stderr")
    if not (out["configs"] < out["space_size"]
            and note.get("unwalked") == out["space_size"] - out["configs"]
            and "unwalked_predicted_worse" in note):
        raise RuntimeError(f"entry points: the budget did not cut the walk, or "
                           f"its coverage note is wrong: {out}")
    x = torch.from_numpy(np.random.RandomState(0).randn(A.num_cols)
                         .astype(np.float32)).to(device)
    B = convert(A, out["best_format"])
    y = build_spmv(B, out["best_format_config"])(x).double().cpu().numpy()
    ref = reference_spmv(A, x)
    rel = np.linalg.norm(y - ref) / np.linalg.norm(ref)
    log(f"  best_format's plan against the oracle: relative error {rel:.3e}")
    if out["best_format"] not in FORMATS or not rel <= 1e-4:
        raise RuntimeError(f"entry points: best_format {out['best_format']} "
                           f"{out['best_format_config']} fails the oracle ({rel:.3e})")


def cusparse_lines(device, matrices):
    """impl="cusparse" (backend/tsparse.py) on poisson5pt 1000x1000 and the
    skewed 1M against the oracle, its device ms beside the `cuda` impl's in
    turns (cuda, cusparse, cusparse, cuda; a CUDA graph's replay, as the
    tuner times: torch.profiler may record no kernel of a window late in a
    long process); and the yardstick's canonical tensor (to_torch_sparse:
    columns sorted, repeats summed) against the CSR tensor of the stored
    arrays it replaced, in turns, on the skewed 1M, whose rows hold
    unsorted and repeated columns."""
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    from cusp_autotuned_tpu_torch.benchmarks.harness import graph_time_s
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    for name in ("poisson5pt 1000x1000 f32", "random 1M rows, skewed"):
        A = matrices[name]
        x = seeded_x(A.num_cols, 9, device)
        fns = {impl: build_spmv(A, {"impl": impl}) for impl in ("cuda", "cusparse")}
        ref = reference_spmv(A, x)
        rel = {impl: np.linalg.norm(fn(x).double().cpu().numpy() - ref)
               / np.linalg.norm(ref) for impl, fn in fns.items()}
        ms = {"cuda": [], "cusparse": []}
        for impl in ("cuda", "cusparse", "cusparse", "cuda"):
            ms[impl].append(graph_time_s(fns[impl], x) * 1e3)
        log(f"entry points: impl=cusparse on {name} ({A.nnz} nnz): relative error "
            f"{rel['cusparse']:.3e} against the oracle (cuda {rel['cuda']:.3e}); "
            f"device ms in turns: cuda {', '.join(f'{t:.4f}' for t in ms['cuda'])}; "
            f"cusparse {', '.join(f'{t:.4f}' for t in ms['cusparse'])} ({CARD[0]})")
        if not rel["cusparse"] <= 1e-4:
            raise RuntimeError(f"entry points: impl=cusparse differs from the oracle "
                               f"on {name} by {rel['cusparse']:.3e}")
    A = matrices["random 1M rows, skewed"]
    x = seeded_x(A.num_cols, 9, device)
    stored = torch.sparse_csr_tensor(A.indptr, A.col[:A.nnz], A.val[:A.nnz].float(),
                                     size=A.shape)
    canonical = sparse_csr(A)
    diff = float((stored @ x - canonical @ x).abs().max())
    t = {"stored": [], "canonical": []}
    for k in ("stored", "canonical", "canonical", "stored"):
        t[k].append(median_ms(library_spmv(A, x, stored if k == "stored" else canonical)))
    log(f"entry points: the cuSPARSE yardstick on the skewed 1M: stored arrays "
        f"({stored.values().numel()} entries) {', '.join(f'{v:.4f}' for v in t['stored'])} "
        f"ms/call, to_torch_sparse ({canonical.values().numel()} entries) "
        f"{', '.join(f'{v:.4f}' for v in t['canonical'])} ms/call in turns; max "
        f"|y difference| {diff:.3e}")


def finite(value):
    """Every number in an example's returned dict is finite (None: a
    strategy the example reports as skipped)."""
    if isinstance(value, dict):
        return all(finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


def examples_on_card(device):
    """The nine examples (cusp_autotuned_tpu_torch/examples) on the card,
    each also on the CPU: every number finite, every iteration count the
    CPU run's (within EXAMPLE_F32_SLACK for an f32 solve), every solve
    that converges on the CPU converged, the same strategies skipped."""
    from cusp_autotuned_tpu_torch import examples
    for name in examples.NAMES:
        main_fn = examples.load(name).main
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            card = main_fn(device)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = main_fn("cpu")
        cpu_s = time.perf_counter() - t0
        for line in printed.getvalue().splitlines():
            log(f"    {name}| {line}")
        log(f"entry points: example {name} on the card in {card_s:.1f} s (the CPU "
            f"run {cpu_s:.1f} s): {card}")
        if not finite(card):
            raise RuntimeError(f"entry points: example {name} printed a number that "
                               f"is not finite: {card}")
        for key, want in cpu.items():
            got = card[key]
            if "iterations" in key:
                slack = 0 if (name, key) in EXAMPLE_F64_COUNTS else EXAMPLE_F32_SLACK
                bad = abs(got - want) > slack
            elif "converged" in key:
                bad = want and not got
            elif key == "errors":
                bad = {k for k, v in got.items() if v is None} != \
                    {k for k, v in want.items() if v is None}
            else:
                continue
            if bad:
                raise RuntimeError(f"entry points: example {name}: {key} {got} on the "
                                   f"card, {want} on the CPU")


def entry_points_phase(device, matrices):
    """The entry-points path: the CLI as a process of its own, the cusparse
    baseline, and the nine examples on the card."""
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    reset_counts()
    cli_subprocess(device)
    cusparse_lines(device, matrices)
    examples_on_card(device)
    launches = read_counts()
    log(f"entry points: path in {time.perf_counter() - t_path:.1f} s; launches "
        f"{launches}")
    return launches


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
    CARD[0] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True).stdout.strip()
    log(CARD[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    t_start = time.perf_counter()
    seconds = {}                     # by phase, for the run's time budget
    last = [t_start]

    def done(phase):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[phase] = now - last[0]
        last[0] = now

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process "
        f"a source)")
    done("build")

    triad_gbps, triad = triad_phase(device)
    records = {"stream_triad": triad, "dia_spmv": dia_phase(device, triad_gbps)}
    done("triad and dia_spmv")
    t0 = time.perf_counter()
    matrices = {
        "poisson5pt 1000x1000 f32": gallery.poisson5pt(1000, 1000, format="csr",
                                                       device=device),
        "random 1M rows, skewed": spmv_tiles.skewed(1_000_000, 2, device),
        "uniform random 1M x 1M": uniform_csr(1_000_000, 8, 3, device),
        "power-law 1M rows": powerlaw_csr(1_000_000, 10_000_000, 4, device),
    }
    log(f"matrices built in {time.perf_counter() - t0:.1f} s")
    done("matrices")
    records["csr_spmv"] = csr_phase(device, triad_gbps, matrices)
    records.update(rails_phase(device, triad_gbps, matrices))
    done("csr_spmv, binned_spmv, coo_spmv")
    records["dia_spmm"] = dia_spmm_phase(device, triad_gbps)
    records.update(rails_spmm_phase(device, triad_gbps, matrices))
    done("dia_spmm, binned_spmm, coo_spmm")
    records.update(new_rails_phase(device, triad_gbps, matrices))
    done("colsort2 and routed")
    records["take_probe"] = take_probe_phase(device, triad_gbps)
    records.update(band_phase(device, triad_gbps,
                              matrices["poisson5pt 1000x1000 f32"],
                              matrices["random 1M rows, skewed"]))
    done("take_probe and the band kernels")
    del matrices["uniform random 1M x 1M"]
    probe_records, probe_launches = probes_phase(device, triad_gbps)
    records.update(probe_records)
    done("probes")

    cg_launches, b, viadia_its, viadia_rel = cg_phase(
        device, matrices["poisson5pt 1000x1000 f32"])
    done("cg.cu")
    krylov_launches = krylov_phase(device, matrices["poisson5pt 1000x1000 f32"], b)
    done("krylov")
    graph_launches = graph_phase(device, matrices["poisson5pt 1000x1000 f32"], b)
    done("graph")
    spgemm_launches = spgemm_phase(device, matrices["poisson5pt 1000x1000 f32"])
    done("spgemm")
    amg_launches, amg_its, M, b_amg = amg_phase(device)
    done("amg")
    mesh_launches = multidevice_phase(
        device, matrices["poisson5pt 1000x1000 f32"], b, viadia_its, viadia_rel,
        M, b_amg, amg_its, matrices)
    done("multidevice")
    del M, b_amg, matrices["power-law 1M rows"]
    tuned_launches, _ = autotune_phase(device, matrices, b, viadia_its)
    done("autotune")
    spmm_launches = spmm_phase(device, matrices)
    done("spmm")
    entry_launches = entry_points_phase(device, matrices)
    done("entry points")
    del matrices
    suite_launches = suite_phase(device)
    done("suite")
    bench_launches = bench_path(device, BENCH_BUDGET_S)
    done("bench")
    log(f"launches: cg.cu path {cg_launches}; krylov path {krylov_launches}; "
        f"graph path {graph_launches}; spgemm path {spgemm_launches}; amg path "
        f"{amg_launches}; "
        f"multidevice path {mesh_launches}; autotune path {tuned_launches}; spmm "
        f"path {spmm_launches}; entry points path {entry_launches}; suite path "
        f"{suite_launches}; probes path {probe_launches}; bench path "
        f"{bench_launches}")
    missing = [k for k in SPMV_KERNELS if tuned_launches[k] < 1] + \
        [k for k in ("dia_spmv", "csr_spmv") if cg_launches[k] < 1] + \
        [k for k in KRYLOV_KERNELS if krylov_launches[k] < 1] + \
        [k for k in GRAPH_KERNELS if graph_launches[k] < 1] + \
        [k for k in SPGEMM_KERNELS if spgemm_launches[k] < 1] + \
        [k for k in ("dia_spmv", "csr_spmv", "take_probe") if amg_launches[k] < 1] + \
        [k for k in SPMM_KERNELS if spmm_launches[k] < 1] + \
        [k for k in ENTRY_KERNELS if entry_launches[k] < 1] + \
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
                cg_launches, krylov_launches, graph_launches, spgemm_launches,
                amg_launches,
                mesh_launches,
                tuned_launches, spmm_launches, entry_launches, suite_launches,
                probe_launches, bench_launches)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"]})
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
