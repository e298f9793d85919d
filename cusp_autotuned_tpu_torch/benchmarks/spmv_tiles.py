"""Time the CSR kernel (the `cuda` impl), the COO kernel (`colsort`), the
colsort2 and routed kernels and the DIA and binned SpMVs against cuSPARSE
on the card, with every working set out of L2; with `--spmm`, the SpMM
kernels.

    python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles [--sweep] [--rails] \
        [--plans LABEL,...]
    python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles --spmm [--k 3,16,128] \
        [--plans LABEL,...]
    python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles --turns N \
        [--against TREE] "MATRIX[ k=K]|PLAN[|PLAN]" ...

The matrices are those of `PERF.md` rows 4, 6, 7, 8 and 12: poisson5pt
1000x1000 f32, the skewed 1M-row matrix (Pareto row lengths of 1 to 4096,
seed 2), its first band of four (250,000 rows, the mesh path's COO band),
Economics and LP of williams_suite(2.0) (LP: 2,000 rows of ~1,300
entries); and a 1M-row matrix whose entries all lie in its last 4,096
rows, 8 a row, so that 999,904 empty rows lead.  The colsort2 and routed
plans (rows 7 and 8) are timed on poisson, the skewed 1M, Economics and
LP: chip_smoke.py's colsort2 plan (two planes of 8 entries) and the
defaults; `--rails` times those rows alone.  For each plan it prints the
device ms (a CUDA graph's replay) and the ms a call back to back, both
from `harness.time_cold`, the CUDA kernels one call launches (torch.profiler,
fills included), the bound (the useful bytes over 3.35 TB/s) and
cuSPARSE's two times on the same input (backend/tsparse.py's
`to_torch_sparse(A) @ x`, a yardstick the port's plans never call).

The default runs the shipped plans (block 256; values_per_thread 4 for
COO), and the DIA SpMV (rows 1 and 2, on poisson5pt 1000x1000 and
2000x2000 as DIA) and the binned SpMV (row 5, on poisson5pt 1000x1000 and
the skewed 1M) with their default plans.  `--plans` keeps the plans of the
listed labels alone (in either mode).  `--sweep` times the CSR kernel at
blocks of 128, 256 and 512, and the COO kernel at values_per_thread 4, 8
and 16 and blocks of 256 and 512.
The script uses only the rails' plan builders and the harness, so run as a
file it times an older tree of the package as well (put that tree first on
PYTHONPATH).  The last line is a JSON record of every row.  Needs one CUDA
card.  chip_smoke.py takes its skewed matrix and its L2-cold lines from
here.

`--spmm` times the SpMM kernels on blocks X (n, k) of f32, for each k of
`--k` (default 3, 16 and 128): the DIA SpMM (`PERF.md` row 3) on
poisson5pt 1000x1000 as DIA, its band twin (row 11) on band 0 of four of
the same matrix (the banded via_dia plan's block apply), and the COO SpMM
(row 6'), the colsort2 SpMM (row 7, the SpMV rows' two plans), the binned
SpMM (row 5', its rows binned by length and, "binned tpr=1", in row order)
and the routed SpMM (row 8, the SpMV rows' plans) on
poisson5pt 1000x1000 and the skewed 1M.  Each beside cuSPARSE on the same X and its
bound: the matrix once (DIA: its padded diagonals), X read and Y written
once.

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

from cusp_autotuned_tpu_torch.backend.tsparse import to_torch_sparse
from cusp_autotuned_tpu_torch.benchmarks import harness
from cusp_autotuned_tpu_torch.kernels.binned import build_binned
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort
from cusp_autotuned_tpu_torch.kernels.colsort2 import build_colsort2
from cusp_autotuned_tpu_torch.kernels.csr import build_csr
from cusp_autotuned_tpu_torch.kernels.dia import build_dia
from cusp_autotuned_tpu_torch.kernels.routed import build_routed
from cusp_autotuned_tpu_torch.utils.device_time import kernels_a_call
from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM data sheet, 700 W
BANDS = 4                           # the mesh path's bands of the skewed matrix
SAMPLES, PER_SAMPLE = 15, 20
SPMM_K = (3, 16, 128)


def on_dia(build_dia):
    """build_dia for a matrix of any format: the plan function converts
    it to DIA first."""
    def build(A, config):
        from cusp_autotuned_tpu_torch.ops.convert import convert
        return build_dia(A if A.format == "dia" else convert(A, "dia"), config)
    return build


def binned_bins_ascending(A, config):
    """The binned plan with its SpMM walk list in the bins' own order, the
    fewest lanes a row first: the order that the shipped list reverses, so
    that the longest rows' warps start first.  Measured, never shipped."""
    from cusp_autotuned_tpu_torch.kernels.binned import spmm_walk
    fn = build_binned(A, config)
    a = fn.planned_arrays
    walk = spmm_walk(a["indptr"].cpu().numpy(), a["perm"].cpu().numpy(),
                     a["bins"].numpy()[::-1], fn.plan_stats["spmm_cap"])
    a["walk"] = tuple(torch.from_numpy(t).to(A.device) for t in walk)
    return fn


BUILDERS = {"cuda": build_csr, "colsort": build_colsort,
            "colsort2": build_colsort2, "routed": build_routed,
            "binned": build_binned, "dia": on_dia(build_dia),
            "binned_ascending": binned_bins_ascending}
# the matrices each impl is timed on
RAIL_MATRICES = ("poisson5pt 1000x1000", "skewed 1M", "Economics", "LP")
ON = {"cuda": ("poisson5pt 1000x1000", "skewed 1M", "LP",
               "1M rows, the last 4096 full"),
      "colsort": ("poisson5pt 1000x1000", "skewed 1M", f"skewed 1M band 0 of {BANDS}",
                  "1M rows, the last 4096 full"),
      "colsort2": RAIL_MATRICES, "routed": RAIL_MATRICES,
      "dia": ("poisson5pt 1000x1000", "poisson5pt 2000x2000"),
      "binned": ("poisson5pt 1000x1000", "skewed 1M")}
# plans that only --turns times
TURN_PLANS = {"routed block=512": ("routed", {"block_size": 512}),
              "dia default": ("dia", {}), "binned default": ("binned", {}),
              "binned tpr=1": ("binned", {"threads_per_row": 1}),
              "binned bins ascending": ("binned_ascending", {})}
# the SpMM plans --spmm times at every k beside the DIA and COO SpMMs
SPMM_PLANS = (("colsort2 K=2 V=8", "colsort2", {"vrow_planes": 2, "vrow_len": 8,
                                                "block_size": 256}),
              ("colsort2 default", "colsort2", {}),
              ("binned default", "binned", {}),
              ("binned tpr=1", "binned", {"threads_per_row": 1}),
              ("routed default", "routed", {}))


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
    """(name, f32 CSR) of the timed matrices; with `only` (a name or a
    collection of names), those alone."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    n = 1_000_000
    make = {
        "poisson5pt 1000x1000": lambda: gallery.poisson5pt(1000, 1000, format="csr",
                                                           device=device),
        "poisson5pt 2000x2000": lambda: gallery.poisson5pt(2000, 2000, format="csr",
                                                           device=device),
        "skewed 1M": lambda: skewed(n, 2, device),
        f"skewed 1M band 0 of {BANDS}": lambda: skewed(n, 2, device, -(-n // BANDS)),
        "Economics": None, "LP": None,
        "1M rows, the last 4096 full": lambda: leading_gap(n, 4096, 8, 3, device)}
    wanted = (only,) if isinstance(only, str) else only
    for name, build in make.items():
        if wanted is not None and name not in wanted:
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
             for m in ("csr", "colsort", "colsort2", "routed", "binned", "dia")}
        return {"cuda": k["csr"].build_csr, "colsort": k["colsort"].build_colsort,
                "colsort2": k["colsort2"].build_colsort2,
                "routed": k["routed"].build_routed,
                "binned": k["binned"].build_binned,
                "dia": on_dia(k["dia"].build_dia)}
    finally:
        sys.path.remove(str(tree))
        take()
        sys.modules.update(mine)


def seeded_input(n, k, device):
    """The timed x (n,) where k is 0, else a block X (n, k), f32, seed 4."""
    rng = np.random.RandomState(4)
    x = rng.randn(n) if k == 0 else rng.randn(n, k)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def useful_bytes(impl, A, k=0):
    """The bytes a product must move: the matrix once (CSR for the CSR-based
    plans, row, column and value an entry for COO, the padded diagonals of
    A's DIA form for DIA), x read once and y written once (k columns each
    where k > 0)."""
    m, n, width = A.num_rows, A.num_cols, max(k, 1)
    if impl == "dia":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        D = A if A.format == "dia" else convert(A, "dia")
        matrix = D.num_diagonals * D.rows_padded * 4
    elif impl == "colsort":
        matrix = A.nnz * 12
    else:
        matrix = A.nnz * 8 + (m + 1) * 4
    return matrix + (n + m) * width * 4


def turns(pairs, rounds, against=None):
    """For each "MATRIX[ k=K]|A[|B]" of `pairs`, the device ms of its two
    plans, L2-cold, in `rounds` rounds, the order swapped each round;
    printed with the medians and B's wins, and returned as rows."""
    device = torch.device("cuda")
    other = tree_builders(against) if against else None
    labels = {label: (impl, cfg) for label, impl, cfg in plans(True)}
    labels.update(TURN_PLANS)
    rows = []
    for spec in pairs:
        name, *pl = spec.split("|")
        base, _, k = name.partition(" k=")
        k = int(k or 0)
        A = matrix(base, device)
        x = seeded_input(A.num_cols, k, device)
        (ia, ca), (ib, cb) = labels[pl[0]], labels[pl[-1]]
        nbytes = useful_bytes(ib, A, k)
        fns = [(other[ia] if len(pl) == 1 else BUILDERS[ia])(A, ca), BUILDERS[ib](A, cb)]
        tags = [f"{against} {pl[0]}" if len(pl) == 1 else pl[0], pl[-1]]
        ref, got = fns[0](x), fns[1](x)
        same = bool(torch.equal(ref, got))
        differ = ref != got
        differ = int((differ if k == 0 else differ.any(1)).sum())
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
              f"{same} ({differ} rows differ)\n  A "
              + " ".join(f"{t:.4f}" for t in ms[0])
              + "\n  B " + " ".join(f"{t:.4f}" for t in ms[1])
              + f"\n  median A {np.median(ms[0]):.4f} ms, B {np.median(ms[1]):.4f} ms "
              f"device; B faster in {wins} of {rounds} rounds", flush=True)
        rows.append({"matrix": name, "a": tags[0], "b": tags[1], "a_ms": ms[0],
                     "b_ms": ms[1], "b_wins": wins, "bitwise_equal": same,
                     "rows_differ": differ})
        del A, x, fns, calls, ref, got
        torch.cuda.empty_cache()
    return rows


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
        yield "dia default", "dia", {}
        yield "binned default", "binned", {}
        for block in ((128, 256, 512) if sweep else (256,)):
            yield f"csr block={block}", "cuda", {"block_size": block}
        for vpt in ((4, 8, 16) if sweep else (4,)):
            for block in ((256, 512) if sweep else (256,)):
                yield (f"coo vpt={vpt} block={block}", "colsort",
                       {"values_per_thread": vpt, "block_size": block})
    yield "colsort2 K=2 V=8", "colsort2", {"vrow_planes": 2, "vrow_len": 8,
                                           "block_size": 256}
    yield "colsort2 default", "colsort2", {}
    yield "routed default", "routed", {}


def timed_row(label, fn, x, nbytes, ref, rows, **keys):
    """Time the plan fn on x L2-cold, print its line beside the bound and
    its largest difference from cuSPARSE's product ref, and append it to
    rows."""
    err = float((fn(x).double() - ref).abs().max())
    launched = kernels_a_call(fn, x)
    dev_ms, call_ms = cold(fn, x, nbytes)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"  {label:22s} {dev_ms:.4f} ms device, {call_ms:.4f} ms a "
          f"call, {launched} kernels a call; bound {bound:.4f} ms "
          f"({nbytes} bytes); |y - cuSPARSE's y| {err:.2e}", flush=True)
    rows.append({**keys, "plan": label, "device_ms": dev_ms, "call_ms": call_ms,
                 "kernels": launched, "bound_ms": bound, "max_abs_diff": err})


def library_row(name, S, x, nbytes, rows, **keys):
    """cuSPARSE's L2-cold line for S @ x; returns its product in f64."""
    lib = library_cold(S, x, nbytes)
    print(f"{name}: cuSPARSE {lib[0]:.4f} ms device, {lib[1]:.4f} ms a call",
          flush=True)
    rows.append({**keys, "plan": "cusparse", "device_ms": lib[0],
                 "call_ms": lib[1]})
    return (S @ x).double()


def band_plan(D, device, bands=BANDS):
    """Band 0 of `bands` of the banded via_dia plan of the DIA matrix D as a
    plan on padded blocks (planned_arrays, apply), its rows, and
    x_prep."""
    from cusp_autotuned_tpu_torch import parallel
    from cusp_autotuned_tpu_torch.kernels.dia import dia_band_spmv
    op = parallel.shard_planned_dia(D, parallel.make_row_mesh([device] * bands))
    left = -min(0, min(D.offsets))
    reach = (min(D.offsets), max(D.offsets))

    def apply(arrays, x_pad):
        return dia_band_spmv(arrays["data"], arrays["offsets"], x_pad, left, 0,
                             reach)

    def fn(x_pad):
        return apply(op.arrays[0], x_pad)

    fn.planned_arrays, fn.apply = op.arrays[0], apply
    return fn, op.arrays[0]["data"].shape[1], op.x_prep


def spmm(ks=SPMM_K, wanted=None):
    """The --spmm rows (see the module's docstring) for each k of ks, of the
    plans labelled in `wanted` (all where None)."""
    def keep(label):
        return wanted is None or label in wanted

    from cusp_autotuned_tpu_torch.ops.convert import convert
    device = torch.device("cuda")
    rows = []
    for name, A in matrices(device, ("poisson5pt 1000x1000", "skewed 1M")):
        S = to_torch_sparse(A)
        D = convert(A, "dia") if name.startswith("poisson") else None
        for k in ks:
            X = seeded_input(A.num_cols, k, device)
            keys = {"matrix": name, "k": k}
            print(f"{name}: {A.num_rows} x {A.num_cols}, nnz {A.nnz}, k = {k}",
                  flush=True)
            ref = library_row(f"  {name} k={k}", S, X, useful_bytes("cuda", A, k),
                              rows, **keys)
            if D is not None and keep("dia (row 3)"):
                timed_row("dia (row 3)", build_dia(D, {}), X,
                          useful_bytes("dia", D, k), ref, rows, **keys)
            if keep("coo (row 6')"):
                timed_row("coo (row 6')", build_colsort(A, {}), X,
                          useful_bytes("colsort", A, k), ref, rows, **keys)
            for label, impl, cfg in SPMM_PLANS:
                if keep(label):
                    timed_row(label, BUILDERS[impl](A, cfg), X,
                              useful_bytes(impl, A, k), ref, rows, **keys)
            if D is not None and keep("dia band (row 11)"):
                band, height, x_prep = band_plan(D, device)
                span = max(D.offsets) - min(D.offsets)
                S0 = torch.sparse_csr_tensor(
                    A.indptr[:height + 1], A.col[:int(A.indptr[height])],
                    A.val[:int(A.indptr[height])].float(), size=(height, A.num_cols))
                nbytes = (D.num_diagonals * height * 4
                          + (2 * height + span) * k * 4)
                keys["matrix"] = f"{name} band 0 of {BANDS}"
                ref = library_row(f"  {keys['matrix']} k={k}", S0, X, nbytes,
                                  rows, **keys)
                timed_row("dia band (row 11)", band, x_prep(X), nbytes, ref, rows,
                          **keys)
                del band, S0
            del X, ref
            torch.cuda.empty_cache()
        del A, S, D
        torch.cuda.empty_cache()
    return rows


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
    wanted = (set(argv[argv.index("--plans") + 1].split(","))
              if "--plans" in argv else None)
    if "--spmm" in argv:
        ks = SPMM_K
        if "--k" in argv:
            ks = tuple(int(k) for k in argv[argv.index("--k") + 1].split(","))
        rows = spmm(ks, wanted)
        print(json.dumps({"card": card, "rows": rows}), flush=True)
        return rows
    sweep, rails_only = "--sweep" in argv, "--rails" in argv
    timed = [p for p in plans(sweep, rails_only) if wanted is None or p[0] in wanted]
    rows = []
    for name, A in matrices(device, {m for _, impl, _ in timed for m in ON[impl]}):
        x = seeded_input(A.num_cols, 0, device)
        S = to_torch_sparse(A)
        ref = library_row(f"{name}: {A.num_rows} x {A.num_cols}, nnz {A.nnz}", S,
                          x, useful_bytes("cuda", A), rows, matrix=name)
        for label, impl, cfg in timed:
            if name not in ON[impl]:
                continue
            try:
                fn = BUILDERS[impl](A, cfg)
            except FormatConversionException as e:
                print(f"  {label:22s} refused: {str(e)[:100]}", flush=True)
                continue
            timed_row(label, fn, x, useful_bytes(impl, A), ref, rows, matrix=name)
            del fn
        del A, S, x, ref
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
