"""Time the CSR kernel (the `cuda` impl) and the COO kernel (`colsort`)
against cuSPARSE on the card, with every working set out of L2.

    python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles [--sweep]

The matrices are those of `PERF.md` rows 4, 6 and 12: poisson5pt
1000x1000 f32, the skewed 1M-row matrix (Pareto row lengths of 1 to 4096,
seed 2), its first band of four (250,000 rows, the mesh path's COO band)
and LP of williams_suite(2.0) (2,000 rows of ~1,300 entries); and a 1M-row
matrix whose entries all lie in its last 4,096 rows, 8 a row, so that
999,904 empty rows lead.  For each plan it prints the device ms (a CUDA
graph's replay) and the ms a call back to back, both from
`harness.time_cold`, the CUDA kernels one call launches (torch.profiler,
fills included), the bound (the useful bytes over 3.35 TB/s) and
cuSPARSE's two times on the same input (`torch.sparse_csr_tensor(...) @
x`, a yardstick the port never calls).

The default runs the shipped plans (block 256; values_per_thread 4 for
COO).  `--sweep` times the CSR kernel at blocks of 128, 256 and 512, and
the COO kernel at values_per_thread 4, 8 and 16 and blocks of 256 and 512.
The script uses only build_csr, build_colsort and the harness, so run as a
file it times an older tree of the package as well (put that tree first on
PYTHONPATH).  The last line is a JSON record of every row.  Needs one CUDA
card.  chip_smoke.py takes its skewed matrix and its L2-cold lines from
here.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from cusp_autotuned_tpu_torch.benchmarks import harness
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort
from cusp_autotuned_tpu_torch.kernels.csr import build_csr

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, 700 W
BANDS = 4                           # the mesh path's bands of the skewed matrix
SAMPLES, PER_SAMPLE = 15, 20


def skewed(n, seed, device, rows=None):
    """An n x n matrix whose row lengths follow a heavy-tailed law (Pareto,
    1 to 4096 entries a row), with seeded random columns and values, cut
    to its first `rows` rows."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    rng = np.random.RandomState(seed)
    lengths = np.minimum(1 + (4 * rng.pareto(1.5, n)).astype(np.int64), 4096)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.randint(0, n, indptr[-1]).astype(np.int32)
    val = rng.uniform(-1.0, 1.0, indptr[-1]).astype(np.float32)
    rows = n if rows is None else rows
    nnz = int(indptr[rows])
    return csr_matrix(indptr[:rows + 1], col[:nnz], val[:nnz], (rows, n),
                      device=device)


def leading_gap(n, rows, per_row, seed, device):
    """An n x n matrix whose entries, `per_row` seeded ones a row, all lie in
    its last `rows` rows: n - rows empty rows lead."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    rng = np.random.RandomState(seed)
    lengths = np.zeros(n, np.int64)
    lengths[n - rows:] = per_row
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.randint(0, n, indptr[-1]).astype(np.int32)
    val = rng.uniform(-1.0, 1.0, indptr[-1]).astype(np.float32)
    return csr_matrix(indptr, col, val, (n, n), device=device)


def matrices(device):
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    n = 1_000_000
    yield "poisson5pt 1000x1000", gallery.poisson5pt(1000, 1000, format="csr",
                                                     device=device)
    yield "skewed 1M", skewed(n, 2, device)
    yield f"skewed 1M band 0 of {BANDS}", skewed(n, 2, device, -(-n // BANDS))
    S = gallery.williams_suite(2.0, names=("LP",))["LP"]
    yield "LP", from_scipy(S, "csr", dtype=torch.float32, device=device)
    yield "1M rows, the last 4096 full", leading_gap(n, 4096, 8, 3, device)


def kernels_a_call(fn, x):
    """CUDA kernels that one call of fn(x) launches (torch.profiler)."""
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA")


def cold(fn, x, nbytes, samples=SAMPLES):
    """The plan fn's (device ms, ms a call), L2-cold: copies of its planned
    arrays and of x."""
    def build(i):
        if i == 0:
            return fn, (x,)
        return fn.apply, (harness.fresh(fn.planned_arrays), x.clone())
    device_s, call_s = harness.time_cold(build, nbytes, samples=samples,
                                         per_sample=PER_SAMPLE)
    return device_s * 1e3, call_s * 1e3


def library_cold(S, x, nbytes, samples=SAMPLES):
    """cuSPARSE's (device ms, ms a call), L2-cold, for a sparse CSR tensor
    S and x."""
    def build(i):
        return (lambda S, x: S @ x), ((S, x) if i == 0 else (S.clone(), x.clone()))
    device_s, call_s = harness.time_cold(build, nbytes, samples=samples,
                                         per_sample=PER_SAMPLE)
    return device_s * 1e3, call_s * 1e3


def plans(sweep):
    """(label, impl, config) of each timed plan."""
    for block in ((128, 256, 512) if sweep else (256,)):
        yield f"csr block={block}", "cuda", {"block_size": block}
    for vpt in ((4, 8, 16) if sweep else (4,)):
        for block in ((256, 512) if sweep else (256,)):
            yield (f"coo vpt={vpt} block={block}", "colsort",
                   {"values_per_thread": vpt, "block_size": block})


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        sys.exit("spmv_tiles: needs a CUDA card")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"spmv_tiles: {card}; torch {torch.__version__}", flush=True)
    sweep = "--sweep" in argv
    rows = []
    for name, A in matrices(device):
        m, n, nnz = A.num_rows, A.num_cols, A.nnz
        x = torch.from_numpy(np.random.RandomState(4).randn(n).astype(np.float32)
                             ).to(device)
        csr_bytes = nnz * 8 + (2 * m + 1 + n) * 4
        coo_bytes = nnz * 12 + (n + m) * 4
        S = torch.sparse_csr_tensor(A.indptr, A.col[:A.nnz], A.val[:A.nnz].float(),
                                    size=A.shape)
        lib = library_cold(S, x, csr_bytes)
        print(f"{name}: {m} x {n}, nnz {nnz}; cuSPARSE {lib[0]:.4f} ms device, "
              f"{lib[1]:.4f} ms a call", flush=True)
        rows.append({"matrix": name, "plan": "cusparse", "device_ms": lib[0],
                     "call_ms": lib[1]})
        ref = None
        for label, impl, cfg in plans(sweep):
            if impl == "colsort" and name == "LP":
                continue                      # rows 6 and 12 only
            if impl == "cuda" and name.startswith("skewed 1M band"):
                continue                      # row 12 is the COO band
            fn = (build_csr if impl == "cuda" else build_colsort)(A, cfg)
            nbytes = csr_bytes if impl == "cuda" else coo_bytes
            y = fn(x)
            if ref is None:
                ref = (S @ x).double()
            err = float((y.double() - ref).abs().max())
            launched = kernels_a_call(fn, x)
            dev_ms, call_ms = cold(fn, x, nbytes)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            print(f"  {label:22s} {dev_ms:.4f} ms device, {call_ms:.4f} ms a "
                  f"call, {launched} kernels a call; bound {bound:.4f} ms "
                  f"({nbytes} bytes); |y - cuSPARSE's y| {err:.2e}", flush=True)
            rows.append({"matrix": name, "plan": label, "device_ms": dev_ms,
                         "call_ms": call_ms, "kernels": launched,
                         "bound_ms": bound, "max_abs_diff": err})
            del fn
        del A, S, x, ref
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
