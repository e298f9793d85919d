"""Analytic per-impl SpMV cost model, priced for the port's Hopper kernels
(counterpart of cusp_autotuned_tpu/autotune/cost_model.py).

The reference picks kernels only by measuring them (KTT Tune,
cusp/system/cuda/ktt/multiply.h:106-153).  The JAX package added a model
so that a configuration can be chosen before anything compiles; the port
keeps its interface (`pattern_stats`, `predict`, `recommend_config`,
`model_order_key`) and its uses: the tuner's untuned pick and walk order,
and the smoothed-aggregation set-up's per-level picks.  The JAX package's
prices are a TPU's (a (128, 128)-tile take pass, a slot law per entry);
this model prices each launch plan of the port's impls on one card
(`_price`) as its launches (launch_us each) plus the larger of

  - its throughput time: the bytes it streams (its plan's arrays, x and y
    once) over eff_<impl> x the measured stream-triad rate; x read through
    L1/L2, one 32-byte sector for each distinct (32-row group, 8-column
    group) pair of the pattern, at gather_scale x the index_select probe's
    price an element; and the lane-iterations it issues, idle lanes
    included (a lane an entry for the csr `cuda` kernel's tiles,
    length-binned teams for binned, rail_rows.cuh's walk for colsort2 and
    routed: a warp a chunk of 32 short-row entries of its 32 rows and a
    warp a chunk of a long row; a lane an entry for colsort), at lane_ns
    each;
  - the latency of its longest thread's chain of dependent round trips
    (colsort2's and routed's warps walk a group's chunks or a long row's
    rounds of four; the DIA kernel walks every diagonal for each row; the
    carry folds of the csr `cuda` kernel and of colsort walk the tiles or
    chunks of the longest row), at serial_us (serial_dia_us for the DIA
    kernel) each.

The constants below were fitted on an NVIDIA H100 80GB HBM3 at a 700 W
power limit by `python -m cusp_autotuned_tpu_torch.autotune.fit_cost_model`
(every priced plan timed as the tuner times it, on the matrices that
script lists); `calibrate()` replaces the measured rates (stream_gbps,
gather_ns, segsum_ns) with the card's in use and
`_auto_load_calibration` restores them, keyed by the card's name.  The
model prices vectors x only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.kernels.binned import ENTRIES_PER_LANE, HUB_CAP
from cusp_autotuned_tpu_torch.kernels.colsort2 import HUB_SPLIT, SHORT_ROW, auto_hub_cap
from cusp_autotuned_tpu_torch.kernels.colsort import GAP_ROWS
from cusp_autotuned_tpu_torch.kernels.csr import ENTRIES_PER_THREAD, tile_rows, tile_splits
from cusp_autotuned_tpu_torch.kernels.routed import MAX_TAIL

# Measured and fitted on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
# fit_cost_model.py (368 plans on 31 matrices, with the csr `cuda` kernel
# priced as nnz-balanced tiles and colsort as two launches; model /
# measured median 1.050, quartiles 0.860 and 1.246).  With colsort2 and
# routed priced as rail_rows.cuh's walk the same plans read median 1.115,
# quartiles 0.950 and 1.338.  A refit (median 1.016, quartiles 0.927 and
# 1.111) lowers lane_ns six-fold, with or without a lane price of the
# walk's own, and so tips the near-tie between the DIA kernel and binned
# on small stencil levels (poisson5pt 128², 2.99 against 2.88 us) to
# binned, where the card times the DIA kernel faster: these constants
# stay.  calibrate() measures the first three on the card in use.
DEVICE_MODEL: Dict[str, float] = dict(
    stream_gbps=3063.20,      # stream triad, GB/s
    gather_ns=0.010401,       # index_select, ns an element (4M elements)
    segsum_ns=0.012065,       # sorted index_add_, ns an element
    launch_us=2.25222,        # a kernel launch inside a graph replay
    lane_ns=0.00208385,       # one lane-iteration of a sparse kernel
    gather_scale=0.241937,    # an x sector / the index_select element price
    serial_us=0.114202,       # one dependent round trip of a thread's chain
    serial_dia_us=0.113519,   # one diagonal of the DIA kernel's row loop
    eff_dia=1.0,              # streamed-byte rate / triad rate, per impl
    eff_dense=0.909753,
    eff_cuda=1.0,
    eff_binned=1.0,
    eff_colsort=0.981433,
    eff_colsort2=0.646379,
    eff_routed=0.999933,
)

RAILS = ("cuda", "binned", "colsort", "colsort2", "routed")
SECTOR_ROWS, SECTOR_COLS = 32, 8      # a warp's rows; a 32-byte sector of f32 x
AHEAD = 4                             # chunks of 32 a long row's warp loads ahead
_calibration_checked = False


def _auto_load_calibration() -> None:
    """Replace the measured rates with those persisted by calibrate() for
    the card in use, once per process; without a card nothing changes."""
    global _calibration_checked
    if _calibration_checked:
        return
    _calibration_checked = True
    if not torch.cuda.is_available():
        return
    from cusp_autotuned_tpu_torch.autotune.calibrate import load
    consts = load(torch.cuda.get_device_name(0))
    if consts:
        DEVICE_MODEL.update({k: v for k, v in consts.items() if k in DEVICE_MODEL})


def _host_triplets(A):
    """(row, col, shape) of A's stored entries on the host, sorted by row."""
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, _, shape = coo_arrays(A)
    return np.asarray(row), np.asarray(col), tuple(shape)


def _cached(A, name, compute):
    """compute() cached on the container, keyed by its tensors' storage and
    version counters (an in-place edit computes anew)."""
    from cusp_autotuned_tpu_torch.autotune.tuner import _tensors
    stamp = tuple((t.data_ptr(), t._version) for t in _tensors(A))
    cache = A.__dict__.setdefault("_cost_model_cache", {})
    hit = cache.get(name)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    value = compute()
    cache[name] = (stamp, value)
    return value


def pattern_stats(A) -> Dict[str, Any]:
    """Host-side sparsity-pattern summary: the JAX package's, key for key."""
    def compute():
        row, col, (m, n) = _host_triplets(A)
        nnz = int(row.size)
        out: Dict[str, Any] = dict(m=int(m), n=int(n), nnz=nnz,
                                   density=nnz / max(m * n, 1))
        if nnz:
            off = col.astype(np.int64) - row.astype(np.int64) + (m - 1)
            num_diagonals = int(np.count_nonzero(
                np.bincount(off, minlength=m + n - 1)))
            deg = np.bincount(row, minlength=m)
            out.update(num_diagonals=num_diagonals,
                       dia_fill=nnz / max(num_diagonals * m, 1),
                       mean_degree=nnz / max(m, 1),
                       max_degree=int(deg.max()))
        else:
            out.update(num_diagonals=0, dia_fill=0.0, mean_degree=0.0,
                       max_degree=0)
        return out
    return dict(_cached(A, "stats", compute))


def _steps(d: np.ndarray, lanes) -> np.ndarray:
    """Loop iterations of a team of `lanes` lanes over rows of d entries."""
    return np.maximum(1, -(-d // lanes))


def _block_slots(steps: np.ndarray, rows_per_block: int, block: int) -> int:
    """Lane-iterations of a kernel whose blocks of `block` threads take
    `rows_per_block` consecutive rows each: every block holds its SM's slots
    until its longest row is done."""
    if steps.size == 0:
        return 0
    r = max(1, int(rows_per_block))
    padded = np.zeros(-(-steps.size // r) * r, np.int64)
    padded[:steps.size] = steps
    return int(block * padded.reshape(-1, r).max(axis=1).sum())


# The launch shapes the model prices.  Each rail's block size and routed's
# window are the values that led the most walks on an NVIDIA H100 80GB HBM3
# at 700 W (chip_smoke.py's walks), colsort's values_per_thread and block
# the fastest of benchmarks/spmv_tiles.py's sweep of the two-launch COO
# kernel (16 entries a lane, the old walks' leader, is now the slowest); the
# axes that change a plan's shape by the pattern (binned's threads_per_row,
# colsort2's planes and virtual-row length) are priced at each value.
CUDA_BLOCK = 256
BINNED_BLOCK, BINNED_TPR = 512, (0, 1, 4)
COLSORT_BLOCK, COLSORT_VPT = 256, 4
COLSORT2_BLOCK = 256
ROUTED_BLOCK, ROUTED_WINDOW = 256, 4096


def _csr_blocks(d: np.ndarray, nnz: int, tile: int) -> int:
    """Blocks of the tiled CSR kernel for rows of d entries (kernels/csr.py:
    a tile's rows are walked a tile's worth of rows a block)."""
    if not d.size:
        return 1
    tile_row = tile_rows(torch.from_numpy(np.r_[0, np.cumsum(d)]), nnz, tile)
    return tile_row.shape[0] - 1 + tile_splits(tile_row, d.size, tile)[0].shape[0]


def _rail_rows(d: np.ndarray, thr: int) -> Tuple[int, int]:
    """(lane-iterations, chain) of rail_rows.cuh's walk of the rows of d
    entries that are at most thr long: a warp takes each 32 rows, one
    iteration to set up and one a chunk of 32 of their short rows' entries;
    a warp takes each longer row, one iteration a chunk of 32; the chain is
    two round trips (the column, then x) a chunk of the busiest group or a
    round of AHEAD chunks of the longest long row."""
    short = np.where(d <= min(SHORT_ROW, thr), d, 0)
    groups = np.add.reduceat(short, np.arange(0, d.size, 32)) if d.size else short
    chunks = -(-groups // 32)
    long = d[(d > SHORT_ROW) & (d <= thr)]
    slots = 32 * int((1 + chunks).sum() + (-(-long // 32)).sum())
    chain = 2 * max(int(chunks.max(initial=1)),
                    int((-(-long // (32 * AHEAD))).max(initial=0)))
    return slots, chain


def _rails(deg: np.ndarray, nnz: int, m: int) -> Dict[str, Any]:
    """For each rail, one entry a priced plan: (lane-iterations issued, idle
    lanes included; kernel launches; dependent memory round trips of the
    longest thread, two a loop iteration: the column index, then x; the
    configuration).  Also routed's tail share (from the row lengths)."""
    from cusp_autotuned_tpu_torch.kernels.variants import VROW_LENS, VROW_PLANES
    d = deg.astype(np.int64)
    dmax = int(d.max()) if d.size else 0
    out: Dict[str, Any] = {}
    # the tiled CSR kernel: a lane an entry (each tile's rows are then
    # summed from shared memory, a block for each tile's worth of rows), and
    # the carry fold for the long rows that tiles cut, whose chain walks the
    # tiles of the longest row
    tile = CUDA_BLOCK * ENTRIES_PER_THREAD
    tiles = max(1, -(-nnz // tile))
    blocks = _csr_blocks(d, nnz, tile)
    out["cuda"] = [(blocks * tile, 1 + (tiles > 1), 4 + -(-dmax // tile),
                    {"impl": "cuda", "block_size": CUDA_BLOCK})]
    hub = d > HUB_CAP
    out["binned"] = []
    for tpr in BINNED_TPR:
        if tpr:
            g = np.full(d.shape, tpr, np.int64)
        else:
            need = np.maximum(-(-d // ENTRIES_PER_LANE), 1)
            g = np.minimum(1 << np.ceil(np.log2(need)).astype(np.int64), 32)
        slots = sum(_block_slots(_steps(d[(g == lanes) & ~hub], lanes),
                                 BINNED_BLOCK // lanes, BINNED_BLOCK)
                    for lanes in np.unique(g[~hub]))
        slots += int(BINNED_BLOCK * _steps(d[hub], BINNED_BLOCK).sum())
        steps = np.where(hub, _steps(d, BINNED_BLOCK), _steps(d, g))
        out["binned"].append((slots, 1, 2 * int(steps.max(initial=1)),
                              {"impl": "binned", "threads_per_row": tpr,
                               "block_size": BINNED_BLOCK}))
    # a lane's run loads four entries a round trip; the carry fold adds a
    # row's partials chunk by chunk: a chain as long as the chunks the
    # longest row spans; a run of more than GAP_ROWS empty rows adds y's
    # zero fill
    empty = np.diff(np.r_[-1, np.flatnonzero(d), d.size]) - 1
    out["colsort"] = [(int(nnz), 2 + int(empty.max() > GAP_ROWS),
                       2 * -(-COLSORT_VPT // 4) + -(-dmax // (32 * COLSORT_VPT)),
                       {"impl": "colsort", "values_per_thread": COLSORT_VPT,
                        "block_size": COLSORT_BLOCK})]
    cap = auto_hub_cap(nnz, m)
    hub_iters = 2 * (HUB_SPLIT // 32)
    hub_slots = 32 * _steps(d, 32) + 32 * _steps(d, HUB_SPLIT)
    # colsort2 and routed: rail_rows.cuh's walk of the rows up to the
    # threshold (planes change no lane's work), the hub pair above it
    out["colsort2"] = []
    for K in VROW_PLANES:
        for V in VROW_LENS:
            thr = min(cap, K * (V or -(-cap // K)))
            in_hub = d > thr
            slots, chain = _rail_rows(d, thr)
            out["colsort2"].append((
                slots + int(hub_slots[in_hub].sum()), 1 + 2 * bool(in_hub.any()),
                max(chain, hub_iters if in_hub.any() else 0),
                {"impl": "colsort2", "vrow_planes": K, "vrow_len": V,
                 "block_size": COLSORT2_BLOCK}))
    tail = d > cap
    slots, chain = _rail_rows(d, cap)
    out["routed"] = [(slots + int(hub_slots[tail].sum()), 1 + 2 * bool(tail.any()),
                      max(chain, hub_iters if tail.any() else 0),
                      {"impl": "routed", "window": ROUTED_WINDOW,
                       "block_size": ROUTED_BLOCK})]
    out["routed_tail"] = float(d[tail].sum()) / max(nnz, 1)
    return out


def _sectors(row, col) -> int:
    """x sectors the pattern touches: distinct (32-row group, 8-column
    group) pairs."""
    key = (row.astype(np.int64) // SECTOR_ROWS) * (1 << 32) \
        + col.astype(np.int64) // SECTOR_COLS
    return int(np.unique(key).size)


def features(A) -> Dict[str, Any]:
    """The pattern features the prices read (cached on A)."""
    def compute():
        row, col, (m, n) = _host_triplets(A)
        nnz = int(row.size)
        out = _rails(np.bincount(row, minlength=m), nnz, m)
        out["sectors"] = _sectors(row, col) if nnz else 0
        return out
    return _cached(A, "features", compute)


def _rail_bytes(impl, m, n, nnz, v) -> float:
    base = nnz * (v + 4) + 4 * (m + 1) + (m + n) * v
    if impl == "binned":
        return base + 4 * m                        # the row permutation
    if impl == "colsort":
        return nnz * (v + 8) + (m + n) * v         # row ids
    return base


def _price(dev, kind, kernels, bytes_, sectors=0.0, slots=0, chain=0) -> float:
    """µs of one launch plan: its launches, then the larger of its
    throughput time (bytes over eff_<kind> x the triad rate, x sectors,
    lane-iterations) and the latency of its longest thread's chain of
    dependent round trips (serial_dia_us a diagonal for the DIA kernel,
    serial_us a round trip for the others)."""
    stream = dev["stream_gbps"] * 1e3                  # bytes a µs
    throughput = (bytes_ / (dev[f"eff_{kind}"] * stream)
                  + (sectors * dev["gather_scale"] * dev["gather_ns"]
                     + slots * dev["lane_ns"]) * 1e-3)
    serial = chain * dev["serial_dia_us" if kind == "dia" else "serial_us"]
    return kernels * dev["launch_us"] + max(throughput, serial)


def rail_plans(st, f, v, dev):
    """(config, price arguments) of each rail's plans on a pattern with
    stats `st` and features `f`, values of v bytes."""
    m, n, nnz = st["m"], st["n"], st["nnz"]
    plans = []
    for impl in RAILS:
        for slots, kernels, chain, cfg in f[impl]:
            plans.append((cfg, dict(kind=impl, kernels=kernels,
                                    bytes_=_rail_bytes(impl, m, n, nnz, v),
                                    sectors=f["sectors"], slots=slots,
                                    chain=chain)))
    return plans


def predict(A, x=None, device: Optional[Dict[str, float]] = None,
            allow_low_precision: bool = False) -> Dict[str, Dict[str, Any]]:
    """Predicted SpMV µs per impl class for A and a vector x.

    Returns {label: {"us": float, "config": dict}} for the impls A's format
    can plan and {label: {"skip": reason}} where the port's build_spmv would
    refuse (the tuner's skippable results).  Labels: default (the format's
    plain path), via_dense, via_dia (the DIA kernel, through a conversion
    unless A is DIA), via_dia_bf16 (with allow_low_precision), and for the
    other formats the kernels cuda (nnz-balanced tiles), binned, colsort,
    colsort2 and routed.  A complex matrix has only the default: the
    kernels take real values only."""
    from cusp_autotuned_tpu_torch.kernels.variants import _DEFAULTS
    from cusp_autotuned_tpu_torch.ops.convert import FILL_THRESHOLD, MAX_FILL_RATIO

    _auto_load_calibration()
    dev = dict(DEVICE_MODEL)
    if device:
        dev.update(device)
    st = pattern_stats(A)
    m, n, nnz = st["m"], st["n"], st["nnz"]
    v = A.dtype.itemsize
    stream = dev["stream_gbps"] * 1e3
    vec = (m + n) * v
    out: Dict[str, Dict[str, Any]] = {}

    plain = dict(_DEFAULTS[A.format])
    if A.format == "dia":
        ndiag = len(A.offsets)
        # one slice, product and sum a diagonal over the padded rows
        out["default"] = {"us": 3 * ndiag * (dev["launch_us"]
                                             + 3 * m * v / stream),
                          "config": plain}
    else:
        out["default"] = {"us": nnz * (dev["gather_ns"] + dev["segsum_ns"]) * 1e-3
                          + 2 * dev["launch_us"], "config": plain}
    if A.dtype.is_complex:
        return out

    dense_bytes = m * n * v
    if st["density"] >= 0.25 and dense_bytes <= (32 << 20):
        out["via_dense"] = {"us": _price(dev, "dense", 1, dense_bytes + vec),
                            "config": {"impl": "via_dense"}}
    else:
        out["via_dense"] = {"skip": "fill < 0.25 or dense data > 32 MB"}

    ndiag = st["num_diagonals"]
    dia_size = ndiag * m
    fill_ratio = dia_size / max(1.0, float(nnz))
    if A.format == "dia" or not (fill_ratio > MAX_FILL_RATIO
                                 and dia_size > FILL_THRESHOLD):
        cfg = {"impl": "cuda"} if A.format == "dia" else {"impl": "via_dia"}
        out["via_dia"] = {"us": _price(dev, "dia", 1, dia_size * v + vec,
                                       chain=ndiag), "config": cfg}
        if allow_low_precision and v == 4:
            out["via_dia_bf16"] = {"us": _price(dev, "dia", 1, dia_size * 2 + vec,
                                                chain=ndiag),
                                   "config": {**cfg, "value_dtype": "bfloat16"}}
    else:
        out["via_dia"] = {"skip": f"DIA fill ratio {fill_ratio:.1f} > {MAX_FILL_RATIO}"}

    if A.format == "dia":
        return out
    if nnz == 0:
        for impl in RAILS:
            out[impl] = {"skip": "empty matrix"}
        return out
    # every rail streams at least its entries and the vectors: when that
    # bound already loses to a structured impl, skip the gather features
    # (a sort of the entries) — they cannot change the pick
    best_structured = min((o["us"] for o in out.values() if "us" in o),
                          default=float("inf"))
    floor = dev["launch_us"] + (nnz * (v + 4) + vec) / stream
    if floor >= best_structured:
        for impl in RAILS:
            out[impl] = {"us": floor, "config": {"impl": impl}, "bound": True}
        return out
    f = features(A)
    for cfg, args in rail_plans(st, f, v, dev):
        impl = cfg["impl"]
        if impl == "routed" and f["routed_tail"] > MAX_TAIL:
            out[impl] = {"skip": f"tail of {100 * f['routed_tail']:.1f} % of the "
                                 f"entries > {100 * MAX_TAIL:.0f} %"}
            continue
        us = _price(dev, **args)
        if "us" not in out.get(impl, {}) or us < out[impl]["us"]:
            out[impl] = {"us": us, "config": cfg}
    return out


def recommend_config(A, x=None, device: Optional[Dict[str, float]] = None,
                     allow_low_precision: bool = False
                     ) -> Tuple[Dict[str, Any], float]:
    """(config, predicted µs) of the best-predicted impl, with nothing built
    or timed."""
    pred = predict(A, x, device=device, allow_low_precision=allow_low_precision)
    feasible = {k: v for k, v in pred.items() if "us" in v}
    label = min(feasible, key=lambda k: feasible[k]["us"])
    return dict(feasible[label]["config"]), float(feasible[label]["us"])


DEFAULT_CLASS = ("segsum", "gather", "rowlen", "slices", "default")


def label_of(A, config: Dict[str, Any]) -> str:
    """The label under which predict prices config's impl class on A: the
    format's default kernels are "default", the cuda impl on a DIA matrix
    is "via_dia", and via_dia (or cuda on DIA) with bf16 values is
    "via_dia_bf16"."""
    impl = config.get("impl", "default")
    if impl in DEFAULT_CLASS:
        return "default"
    if impl == "cuda" and A.format == "dia":
        impl = "via_dia"
    if impl == "via_dia" and config.get("value_dtype") == "bfloat16":
        return "via_dia_bf16"
    return impl


def model_order_key(A, device: Optional[Dict[str, float]] = None):
    """A sort key over configurations: the predicted µs of the
    configuration's impl class (label_of; an impl the model does not price
    sorts last, keeping its relative order in a stable sort).  A bf16 DIA
    plan takes the lesser of its own price and the f32 one."""
    pred = predict(A, device=device, allow_low_precision=True)

    def us_of(label: str) -> float:
        return float(pred.get(label, {}).get("us", float("inf")))

    def key(config: Dict[str, Any]) -> float:
        label = label_of(A, config)
        if label == "via_dia_bf16":
            return min(us_of(label), us_of("via_dia"))
        return us_of(label)

    return key
