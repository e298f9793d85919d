"""Time the CSR kernel (the `cuda` impl), the COO kernel (`colsort`) and
the colsort2 and routed kernels against cuSPARSE on the card, with every
working set out of L2.

    python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles [--sweep] [--rails]
    python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles --turns N \
        [--against TREE] "MATRIX|PLAN[|PLAN]" ...

The matrices are those of `PERF.md` rows 4, 6, 7, 8 and 12: poisson5pt
1000x1000 f32, the skewed 1M-row matrix (Pareto row lengths of 1 to 4096,
seed 2), its first band of four (250,000 rows, the mesh path's COO band),
Economics and LP of williams_suite(2.0) (LP: 2,000 rows of ~1,300
entries); and a 1M-row matrix whose entries all lie in its last 4,096
rows, 8 a row, so that 999,904 empty rows lead.  The colsort2 and routed
plans (rows 7 and 8) are timed on poisson, the skewed 1M, Economics and
LP: chip_smoke.py's plans (two planes of 8 entries; 4096-column windows)
and the defaults; `--rails` times those rows alone.  For each plan it
prints the device ms (a CUDA graph's replay) and the ms a call back to
back, both from
`harness.time_cold`, the CUDA kernels one call launches (torch.profiler,
fills included), the bound (the useful bytes over 3.35 TB/s) and
cuSPARSE's two times on the same input (`torch.sparse_csr_tensor(...) @
x`, a yardstick the port never calls).

The default runs the shipped plans (block 256; values_per_thread 4 for
COO).  `--sweep` times the CSR kernel at blocks of 128, 256 and 512, and
the COO kernel at values_per_thread 4, 8 and 16 and blocks of 256 and 512.
The script uses only the rails' plan builders and the harness, so run as a
file it times an older tree of the package as well (put that tree first on
PYTHONPATH).  The last line is a JSON record of every row.  Needs one CUDA
card.  chip_smoke.py takes its skewed matrix and its L2-cold lines from
here.

`--turns N` times pairs of plans in N rounds, L2-cold device ms (a graph's
replay) of each, the order swapped each round, and prints each pair's
medians and the rounds the second plan won.  "MATRIX|A|B" pairs plans A
and B of this tree; "MATRIX|A" pairs plan A of the package tree at
`--against TREE` (a checkout's root, imported beside this one) with plan A
of this tree.  MATRIX is a name of `matrices()`, an entry of
williams_suite(2.0), or "NAME, rows of at most T" (NAME's rows longer than
T emptied: a plan's main rows alone); PLAN a label of `plans(sweep=True)`
or of TURN_PLANS.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from cusp_autotuned_tpu_torch.benchmarks import harness
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort
from cusp_autotuned_tpu_torch.kernels.colsort2 import build_colsort2
from cusp_autotuned_tpu_torch.kernels.csr import build_csr
from cusp_autotuned_tpu_torch.kernels.routed import build_routed
from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, 700 W
BANDS = 4                           # the mesh path's bands of the skewed matrix
SAMPLES, PER_SAMPLE = 15, 20
BUILDERS = {"cuda": build_csr, "colsort": build_colsort,
            "colsort2": build_colsort2, "routed": build_routed}
# the matrices each impl is timed on
RAIL_MATRICES = ("poisson5pt 1000x1000", "skewed 1M", "Economics", "LP")
ON = {"cuda": ("poisson5pt 1000x1000", "skewed 1M", "LP",
               "1M rows, the last 4096 full"),
      "colsort": ("poisson5pt 1000x1000", "skewed 1M", f"skewed 1M band 0 of {BANDS}",
                  "1M rows, the last 4096 full"),
      "colsort2": RAIL_MATRICES, "routed": RAIL_MATRICES}
# plans that only --turns times
TURN_PLANS = {"routed window=4096 block=512": ("routed", {"window": 4096,
                                                          "block_size": 512})}


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


def matrices(device, only=None):
    """(name, f32 CSR) of the timed matrices; with `only`, that one alone."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    n = 1_000_000
    make = {
        "poisson5pt 1000x1000": lambda: gallery.poisson5pt(1000, 1000, format="csr",
                                                           device=device),
        "skewed 1M": lambda: skewed(n, 2, device),
        f"skewed 1M band 0 of {BANDS}": lambda: skewed(n, 2, device, -(-n // BANDS)),
        "Economics": None, "LP": None,
        "1M rows, the last 4096 full": lambda: leading_gap(n, 4096, 8, 3, device)}
    for name, build in make.items():
        if only not in (None, name):
            continue
        if build is None:
            S = gallery.williams_suite(2.0, names=(name,))[name]
            yield name, from_scipy(S, "csr", dtype=torch.float32, device=device)
        else:
            yield name, build()


def short_rows(S, cut):
    """The scipy CSR matrix S with its rows of more than `cut` entries
    emptied."""
    lengths = np.diff(S.indptr)
    kept = np.where(lengths <= cut, lengths, 0)
    mask = np.repeat(kept > 0, lengths)
    return type(S)((S.data[mask], S.indices[mask], np.r_[0, np.cumsum(kept)]),
                   shape=S.shape)


def matrix(name, device):
    """The matrix `name` (see the module's docstring) as an f32 CSR."""
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
    from cusp_autotuned_tpu_torch.gallery.suite import williams_suite
    base, _, cut = name.partition(", rows of at most ")
    if cut:
        S = short_rows(to_scipy(matrix(base, device)).tocsr(), int(cut))
        return from_scipy(S, "csr", dtype=torch.float32, device=device)
    for _, A in matrices(device, only=base):
        return A
    S = williams_suite(2.0, names=(base,))[base]
    return from_scipy(S, "csr", dtype=torch.float32, device=device)


def tree_builders(tree):
    """BUILDERS of the package at `tree`, imported beside this one: its
    modules load under the package's own name while this tree's are set
    aside, and trade places with them after."""
    pkg = harness.__name__.split(".")[0]

    def take():
        return {k: sys.modules.pop(k) for k in list(sys.modules)
                if k == pkg or k.startswith(pkg + ".")}

    mine = take()
    sys.path.insert(0, str(tree))
    try:
        k = {m: importlib.import_module(f"{pkg}.kernels.{m}")
             for m in ("csr", "colsort", "colsort2", "routed")}
        return {"cuda": k["csr"].build_csr, "colsort": k["colsort"].build_colsort,
                "colsort2": k["colsort2"].build_colsort2,
                "routed": k["routed"].build_routed}
    finally:
        sys.path.remove(str(tree))
        take()
        sys.modules.update(mine)


def turns(pairs, rounds, against=None):
    """For each "MATRIX|A[|B]" of `pairs`, the device ms of its two plans,
    L2-cold, in `rounds` rounds, the order swapped each round; printed with
    the medians and B's wins, and returned as rows."""
    device = torch.device("cuda")
    other = tree_builders(against) if against else None
    labels = {label: (impl, cfg) for label, impl, cfg in plans(True)}
    labels.update(TURN_PLANS)
    rows = []
    for spec in pairs:
        name, *pl = spec.split("|")
        A = matrix(name, device)
        x = torch.from_numpy(np.random.RandomState(4).randn(A.num_cols)
                             .astype(np.float32)).to(device)
        nbytes = A.nnz * 8 + (2 * A.num_rows + 1 + A.num_cols) * 4
        (ia, ca), (ib, cb) = labels[pl[0]], labels[pl[-1]]
        fns = [(other[ia] if len(pl) == 1 else BUILDERS[ia])(A, ca), BUILDERS[ib](A, cb)]
        tags = [f"{against} {pl[0]}" if len(pl) == 1 else pl[0], pl[-1]]
        ref = fns[0](x)
        same = bool(torch.equal(ref, fns[1](x)))
        calls = []
        for fn in fns:
            def build(i, fn=fn):
                if i == 0:
                    return fn, (x,)
                return fn.apply, (harness.fresh(fn.planned_arrays), x.clone())
            call, copies = harness.cold_call(build, nbytes, device)
            calls.append((call, copies * -(-harness.REPEATS // copies)))
        ms = [[], []]
        for r in range(rounds):
            for k in ((0, 1) if r % 2 == 0 else (1, 0)):
                call, repeats = calls[k]
                ms[k].append(harness.graph_time_s(call, repeats=repeats,
                                                  device=device) * 1e3)
        wins = sum(b < a for a, b in zip(*ms))
        print(f"turns {name}: A = {tags[0]}, B = {tags[1]}; y equal bit for bit: "
              f"{same}\n  A " + " ".join(f"{t:.4f}" for t in ms[0])
              + "\n  B " + " ".join(f"{t:.4f}" for t in ms[1])
              + f"\n  median A {np.median(ms[0]):.4f} ms, B {np.median(ms[1]):.4f} ms "
              f"device; B faster in {wins} of {rounds} rounds", flush=True)
        rows.append({"matrix": name, "a": tags[0], "b": tags[1], "a_ms": ms[0],
                     "b_ms": ms[1], "b_wins": wins, "bitwise_equal": same})
        del A, x, fns, calls, ref
        torch.cuda.empty_cache()
    return rows


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


def plans(sweep, rails_only=False):
    """(label, impl, config) of each timed plan."""
    if not rails_only:
        for block in ((128, 256, 512) if sweep else (256,)):
            yield f"csr block={block}", "cuda", {"block_size": block}
        for vpt in ((4, 8, 16) if sweep else (4,)):
            for block in ((256, 512) if sweep else (256,)):
                yield (f"coo vpt={vpt} block={block}", "colsort",
                       {"values_per_thread": vpt, "block_size": block})
    yield "colsort2 K=2 V=8", "colsort2", {"vrow_planes": 2, "vrow_len": 8,
                                           "block_size": 256}
    yield "colsort2 default", "colsort2", {}
    yield "routed window=4096", "routed", {"window": 4096, "block_size": 256}
    yield "routed default", "routed", {}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        sys.exit("spmv_tiles: needs a CUDA card")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"spmv_tiles: {card}; torch {torch.__version__}", flush=True)
    if "--turns" in argv:
        i = argv.index("--turns")
        rounds, rest = int(argv[i + 1]), argv[:i] + argv[i + 2:]
        against = None
        if "--against" in rest:
            j = rest.index("--against")
            against, rest = rest[j + 1], rest[:j] + rest[j + 2:]
        rows = turns(rest, rounds, against)
        print(json.dumps({"card": card, "turns": rows}), flush=True)
        return rows
    sweep, rails_only = "--sweep" in argv, "--rails" in argv
    timed = list(plans(sweep, rails_only))
    rows = []
    for name, A in matrices(device):
        if not any(name in ON[impl] for _, impl, _ in timed):
            continue
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
        for label, impl, cfg in timed:
            if name not in ON[impl]:
                continue
            try:
                fn = BUILDERS[impl](A, cfg)
            except FormatConversionException as e:
                print(f"  {label:22s} refused: {str(e)[:100]}", flush=True)
                continue
            nbytes = coo_bytes if impl == "colsort" else csr_bytes
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
