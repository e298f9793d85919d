"""The row walk of the colsort2 and routed SpMV kernels (csrc/rail_rows.cuh)
and its plans, on the CPU.

The kernels run only on the card; what they read is planned here by
build_colsort2 and build_routed (the long rows and the hub region).  So
the tests walk the kernels' algorithm in numpy over the planned warps: the
short rows of each warp's 32 rows located chunk by chunk (the gapless
index or the five-step search over the prefix sums), each summed by its
lane in plane order; each long row by a warp, lane-strided within each
plane, folded by the shuffle tree.  Every main row of y is written once,
the f64 walk equals the plain version and scipy within 1e-12, and an f32
walk of a row band equals the whole matrix's walk on those rows bit for
bit: the order is fixed by the row alone.  tests/test_torch_cuda.py holds
the kernels themselves to the plain versions on the card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.benchmarks import spmv_tiles
from cusp_autotuned_tpu_torch.kernels.colsort2 import (
    SHORT_ROW, build_colsort2, colsort2_spmv_plain, long_rows, plan_colsort2,
)
from cusp_autotuned_tpu_torch.kernels.routed import build_routed, routed_spmv_plain

from tests.torch_parity import one_thread  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)
NO_PLANES = 2**31 - 1                 # kNoPlanes: routed's rows are one plane
SLOTS = 128                           # kSlots: short-row products a warp loads at once

# row lengths: short (<= 32) and long rows, hub rows, empty rows and runs
PATTERNS = {
    "mixed lengths with long and hub rows":
        list(np.random.RandomState(3).randint(0, 70, 700)) + [300, 0, 33, 32, 1],
    "empty rows at the start, middle and end, and runs of them":
        [0] * 70 + [3, 5] + [0] * 40 + [31, 33, 64, 65] + [0] * 33 + [2] * 50 + [0] * 5,
    "rows of exactly 32 and 33 entries, and 64 and 65": [32, 33] * 20 + [64, 65] * 5,
    "one row": [40],
    "short rows only": [5] * 300 + [4] * 77,
}


def _matrix(lengths, seed=0, n=1000):
    """A seeded f64 scipy CSR matrix with the given row lengths, columns
    drawn without repeats in each row and sorted."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    n = max(n, int(lengths.max(initial=0)))
    indptr = np.r_[0, np.cumsum(lengths)]
    col = np.concatenate([np.sort(rng.choice(n, k, replace=False)) for k in lengths]
                         + [np.zeros(0, np.int64)])
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


def _port(S):
    return from_scipy(S, "csr", dtype=torch.float64, device="cpu")


def tree32(lanes):
    """The shuffle-down tree of 32 lanes: lane 0's sum."""
    a = lanes.copy()
    for off in (16, 8, 4, 2, 1):
        a[:off] = a[:off] + a[off:2 * off]
    return a[0]


def walk(indptr, col, val, x, thr, V, long, block, dtype=np.float64):
    """csrc/rail_rows.cuh in numpy: the short rows warp by warp (blocks of
    `block` rows), 128 entries at a time, each located as the kernel
    locates it and summed by its lane in plane order; then each long row by
    a warp.  Returns (y, writes): y is NaN where the walk wrote nothing (the
    hub rows)."""
    indptr = np.asarray(indptr, np.int64)
    m = indptr.size - 1
    prod = (np.asarray(val, dtype) * np.asarray(x, dtype)[col]).astype(dtype)
    y, writes = np.full(m, np.nan, dtype), np.zeros(m, np.int64)
    lim = min(SHORT_ROW, thr)
    for b in range(-(-m // block)):
        for r0 in range(b * block, min(m, (b + 1) * block), 32):
            rows = np.arange(r0, r0 + 32)
            have = rows < m
            s = np.where(have, indptr[np.minimum(rows, m - 1)], 0)
            L = np.where(have, indptr[np.minimum(rows, m - 1) + 1] - s, 0)
            mine = have & (L <= lim)
            Ls = np.where(mine, L, 0)
            start = np.cumsum(Ls) - Ls
            total = int(Ls.sum())
            gapless = not (have & ~mine & (L > 0)).any()
            want = np.concatenate([np.arange(s[j], s[j] + Ls[j]) for j in range(32)])
            sums = [dtype(0)] * 32
            planes = [dtype(0)] * 32
            pos = [0] * 32
            for c in range(0, total, SLOTS):
                buf = np.zeros(SLOTS, dtype)
                for i in range(c, c + SLOTS):      # lane (i - c) % 32
                    if i >= total:
                        continue
                    if gapless:
                        e = s[0] + i
                    else:
                        j = 0
                        for step in (16, 8, 4, 2, 1):
                            if start[j + step] <= i:
                                j += step
                        e = s[j] + (i - start[j])
                    assert e == want[i], (r0, i)
                    buf[i - c] = prod[e]
                for lane in np.flatnonzero(mine):
                    stop = min(start[lane] + Ls[lane], c + SLOTS)
                    for k in range(max(start[lane], c), stop):
                        planes[lane] = dtype(planes[lane] + buf[k - c])
                        pos[lane] += 1
                        if pos[lane] == V:
                            sums[lane] = dtype(sums[lane] + planes[lane])
                            planes[lane], pos[lane] = dtype(0), 0
            for lane in np.flatnonzero(mine):
                y[r0 + lane] = dtype(sums[lane] + planes[lane])
                writes[r0 + lane] += 1
    for r in long:
        a, b = indptr[r], indptr[r + 1]
        L = b - a
        assert SHORT_ROW < L <= thr
        C = -(-L // 32)
        arr = np.zeros(32 * C, dtype)
        arr[:L] = prod[a:b]
        p = np.arange(32 * C)
        total = dtype(0)
        for k in range(-(-L // V)):
            part = np.where((p >= k * V) & (p < min((k + 1) * V, L)), arr, dtype(0))
            lanes = np.cumsum(part.reshape(C, 32), axis=0, dtype=dtype)[-1]
            total = dtype(total + tree32(lanes))
        y[r] = total
        writes[r] += 1
    return y, writes


def _colsort2_walk(A, cfg, x, dtype=np.float64):
    fn = build_colsort2(A, cfg)
    a, st = fn.planned_arrays, fn.plan_stats
    y, writes = walk(a["indptr"].numpy(), a["col"].numpy(), a["val"].numpy(), x,
                     st["thr"], st["vrow_len"], a["long"].numpy(),
                     cfg.get("block_size", 256), dtype=dtype)
    return fn, y, writes


def _routed_walk(A, cfg, x, dtype=np.float64):
    fn = build_routed(A, cfg)
    a, st = fn.planned_arrays, fn.plan_stats
    y, writes = walk(a["indptr"].numpy(), a["col"].numpy(), a["val"].numpy(), x,
                     st["hub_cap"], NO_PLANES, a["long"].numpy(),
                     cfg.get("block_size", 256), dtype=dtype)
    return fn, y, writes


def _check_main_rows(S, y, writes, thr, plain):
    lengths = np.diff(S.indptr)
    main = lengths <= thr
    assert (writes[main] == 1).all() and (writes[~main] == 0).all()
    np.testing.assert_allclose(y[main], plain[main], **TOL)
    np.testing.assert_allclose(y[main], (S @ _x(S.shape[1]))[main], **TOL)


def _x(n, seed=1):
    return np.random.RandomState(seed).randn(n)


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("K,V,hub_cap", [(2, 8, 0), (2, 32, 0), (4, 0, 0),
                                         (1, 0, 48), (2, 0, 500)])
def test_colsort2_walk_writes_each_main_row_once_and_matches_plain(name, K, V,
                                                                   hub_cap):
    S = _matrix(PATTERNS[name], seed=7)
    A, x = _port(S), _x(S.shape[1])
    fn, y, writes = _colsort2_walk(A, {"vrow_planes": K, "vrow_len": V,
                                       "hub_cap": hub_cap}, x)
    a, st = fn.planned_arrays, fn.plan_stats
    plain = colsort2_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                torch.from_numpy(x), S.shape[0], K,
                                st["vrow_len"], st["thr"]).numpy()
    _check_main_rows(S, y, writes, st["thr"], plain)
    np.testing.assert_allclose(plain, S @ x, **TOL)


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("window,block", [(4096, 256), (16384, 512), (4096, 64)])
def test_routed_walk_writes_each_main_row_once_and_matches_plain(name, window,
                                                                 block):
    S = _matrix(PATTERNS[name], seed=8, n=6000)
    A, x = _port(S), _x(S.shape[1])
    cfg = {"window": window, "block_size": block, "hub_cap": 64}
    fn, y, writes = _routed_walk(A, cfg, x)
    a, st = fn.planned_arrays, fn.plan_stats
    plain = routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                              torch.from_numpy(x), S.shape[0], st["hub_cap"]).numpy()
    _check_main_rows(S, y, writes, st["hub_cap"], plain)


@pytest.mark.parametrize("impl", ["colsort2", "routed"])
def test_f32_walk_of_a_band_equals_the_whole_walk(impl):
    """Rows 250..1199 of a matrix planned alone (as shard_planned_blocks
    plans a band, with the whole matrix's hub_cap) give the whole walk's
    sums on those rows bit for bit, though the band's warps and blocks fall
    elsewhere."""
    lengths = np.random.RandomState(5).randint(0, 90, 1600)
    S = _matrix(lengths, seed=9, n=3000)
    band = S[250:1200]
    x = _x(S.shape[1]).astype(np.float32)
    cfg = {"hub_cap": 80, "window": 4096} if impl == "routed" else \
        {"vrow_planes": 2, "vrow_len": 32, "hub_cap": 80}
    run = _routed_walk if impl == "routed" else _colsort2_walk
    _, y, writes = run(_port(S), cfg, x, np.float32)
    _, yb, wb = run(_port(band), cfg, x, np.float32)
    main = writes[250:1200] == 1
    assert (wb == writes[250:1200]).all() and main.sum() > 600
    assert np.array_equal(yb[main], y[250:1200][main])


def test_lp_sized_rows_take_a_warp_each():
    """2,000 rows of ~1,300 entries (LP's shape): every row is a long row
    under the default plans, a warp each, and the walk equals scipy."""
    rng = np.random.RandomState(4)
    m, n = 2000, 9000
    lengths = rng.randint(1200, 1400, m)
    indptr = np.r_[0, np.cumsum(lengths)]
    col = np.concatenate([np.sort(rng.choice(n, k, replace=False)) for k in lengths])
    S = sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr), shape=(m, n))
    A, x = _port(S), _x(n)
    for run, cfg in ((_colsort2_walk, {}), (_routed_walk, {})):
        fn, y, writes = run(A, cfg, x)
        assert fn.plan_stats["long_rows"] == m and (writes == 1).all()
        np.testing.assert_allclose(y, S @ x, **TOL)


def test_long_rows_and_the_thresholds_at_the_edges():
    """A row of 32 entries is short and one of 33 long; a row of thr entries
    is a main row and one of thr + 1 a hub row."""
    indptr = np.r_[0, np.cumsum([32, 33, 64, 65, 0, 5])]
    thr, V, (hub_rows, *_rest) = plan_colsort2(indptr, K=2, V=32, hub_cap=100)
    assert (thr, V) == (64, 32)
    assert long_rows(indptr, thr).tolist() == [1, 2] and hub_rows.tolist() == [3]
    assert long_rows(indptr, 16).tolist() == []          # thr below SHORT_ROW
    S = _matrix([32, 33, 64, 65, 0, 5])
    fn = build_routed(_port(S), {"hub_cap": 64})
    assert fn.planned_arrays["long"].tolist() == [1, 2]
    assert fn.plan_stats["tail"] == 65


def test_routed_walk_at_the_edge_of_x():
    """n = 4,998: rows that read x's last 300 columns walk to scipy's y."""
    B, n = 64, 4998
    cols = np.repeat(np.arange(n - 300, n), 4)
    rows = np.arange(cols.size) % B
    S = sp.csr_matrix((np.random.RandomState(2).uniform(-1, 1, cols.size),
                       (rows, cols)), shape=(B, n))
    x = _x(n)
    _, y, writes = _routed_walk(_port(S), {"block_size": B}, x)
    assert (writes == 1).all()
    np.testing.assert_allclose(y, S @ x, **TOL)


def test_short_rows_empties_the_longer_rows_alone():
    """spmv_tiles' "NAME, rows of at most T" matrices: a plan's main rows."""
    S = _matrix(PATTERNS["mixed lengths with long and hub rows"], seed=6)
    cut = spmv_tiles.short_rows(S, 16)
    short = np.diff(S.indptr) <= 16
    assert cut.shape == S.shape and (np.diff(cut.indptr)[~short] == 0).all()
    assert (cut[np.flatnonzero(short)] != S[np.flatnonzero(short)]).nnz == 0


def test_tree_builders_import_a_tree_beside_this_one():
    """--against TREE: the tree's builders come from modules of their own,
    and this tree's modules are back in place after."""
    import sys
    from pathlib import Path
    before = sys.modules["cusp_autotuned_tpu_torch.kernels.routed"]
    other = spmv_tiles.tree_builders(Path(spmv_tiles.__file__).parents[2])
    assert sys.modules["cusp_autotuned_tpu_torch.kernels.routed"] is before
    assert other["routed"] is not build_routed
    S = _matrix(PATTERNS["short rows only"], seed=3)
    A, x = _port(S), torch.from_numpy(_x(S.shape[1]))
    assert torch.equal(other["routed"](A, {})(x), build_routed(A, {})(x))
