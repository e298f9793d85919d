"""The plans of the nnz-balanced CSR kernel (csrc/csr_spmv.cu) and the COO
chunk kernel (csrc/coo_spmv.cu) on the CPU.

The kernels run only on the card; what they read is planned here by
build_csr and build_colsort.  So the tests check the plans (tile_row against
numpy's searchsorted, the carry slots' sizes), and walk each kernel's
algorithm in numpy over the planned tiles, lanes and carries: every row of y
written exactly once, and the walk equal to the plain version and to scipy
within 1e-12 in f64.  A fault in the plan or in the carry rules shows here
without a card; tests/test_torch_cuda.py holds the kernels themselves to
the same plain versions on the card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels.colsort import (
    GAP_ROWS, build_colsort, coo_spmv_plain, longest_gap,
)
from cusp_autotuned_tpu_torch.kernels.csr import (
    ENTRIES_PER_THREAD, build_csr, csr_spmv_plain, tile_splits,
)

from tests.torch_parity import one_thread  # noqa: F401

TILE = 256
BLOCK = TILE // ENTRIES_PER_THREAD   # the block size that gives tiles of 256
TOL = dict(rtol=1e-12, atol=1e-12)
SHORT = 32                          # a short row: summed whole by one tile

# row lengths, with tiles of 256 entries
PATTERNS = {
    "empty rows at the start, middle and end":
        [0, 0, 0, 3, 0, 260, 0, 0, 5] + [7, 0, 1] * 30 + [0, 0],
    "a row over more than 3 tiles": [2, 1000, 3, 0, 4],
    "nnz below one tile": [5, 0, 7, 9],
    "nnz a multiple of a tile, a row starting on each tile": [128, 128, 100, 156],
    "nnz a multiple of a tile, rows cut by the tiles": [200, 100, 150, 62],
    "m = 1": [600],
    "3 x 1000": [700, 1000, 300],
    "no entries": [0, 0, 0, 0],
    "runs of more than GAP_ROWS empty rows at the start, middle and end":
        [0] * 40 + [3] + [0] * 33 + [2, 5] + [0] * 100 + [1, 0, 4] + [0] * 35,
    "runs of empty rows longer than a tile":
        [0] * 700 + [5, 300] + [0] * 600 + [3] + [0] * 1000 + [40] * 9 + [0] * 257,
}


def _matrix(lengths, seed=0):
    """A seeded f64 scipy CSR matrix with the given row lengths, columns
    drawn without repeats in each row."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    n = max(1000, int(lengths.max(initial=0)))
    indptr = np.r_[0, np.cumsum(lengths)]
    col = np.concatenate([np.sort(rng.choice(n, k, replace=False)) for k in lengths]
                         + [np.zeros(0, np.int64)])
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


def _x(n, seed=1):
    return np.random.RandomState(seed).randn(n)


def walk_csr(indptr, col, val, x, m, tile_row, tile, split_tile, split_row):
    """csrc/csr_spmv.cu in numpy: the tile kernel's blocks (block t the
    first `tile` rows of tile t, then the splits, each `tile` rows from its
    first), the carry slots (set by a tile's first block), then the fold,
    each sum in the kernel's order.  A short row (at most
    SHORT entries) is summed whole by the tile where it starts; a longer
    row by segments, a carry for each cut one.  Asserts that the blocks
    walk each tile's rows once, in order, at most a tile's count of rows
    each, that every row is written exactly once and that every carry slot
    the tiles name gets its partial."""
    nnz, tiles = int(indptr[-1]), len(tile_row) - 1
    prod = val * x[col]
    y, writes = np.full(m, np.nan), np.zeros(m, np.int64)
    carry_row = np.full(2 * tiles, -7)
    carry_val = np.full(2 * tiles, np.nan)

    def serial(lo, hi):
        acc = 0.0
        for k in range(lo, hi):
            acc += prod[k]
        return acc

    walked = {t: [] for t in range(tiles)}
    for blk in range(tiles + len(split_tile)):
        first = blk < tiles
        t = blk if first else split_tile[blk - tiles]
        t0, t1 = t * tile, (t + 1) * tile
        r_lo = 0 if t == 0 else tile_row[t]
        r_next = tile_row[t + 1]
        w_lo = r_lo if first else split_row[blk - tiles]
        w_hi = min(w_lo + tile - 1, r_next, m - 1)
        assert w_hi >= w_lo
        walked[t] += range(w_lo, w_hi + 1)
        if first:
            lo_a, lo_b = indptr[r_lo], indptr[r_lo + 1]
            carry_row[2 * t] = (r_lo if t > 0 and lo_a < t0 and lo_b - lo_a > SHORT
                                else -1)
            start, stop = (indptr[r_next], indptr[r_next + 1]) if r_next < m else (0, 0)
            carry_row[2 * t + 1] = (r_next if t1 < nnz and t0 <= start < t1
                                    and stop - start > SHORT else -1)
        for r in range(w_lo, w_hi + 1):
            a, b = indptr[r], indptr[r + 1]
            if b - a <= SHORT:
                if a >= t0 and (a < t1 or a == b):
                    y[r] = serial(a, b)
                    writes[r] += 1
                continue
            s, e = max(a, t0), min(b, t1)
            if e <= s:
                continue
            if a >= t0 and b <= t1:
                y[r] = serial(s, e)
                writes[r] += 1
            else:
                slot = 2 * t if a < t0 else 2 * t + 1
                assert carry_row[slot] == r
                carry_val[slot] = serial(s, e)
    for t in range(tiles):
        r_lo = 0 if t == 0 else tile_row[t]
        assert sorted(walked[t]) == list(range(r_lo, min(tile_row[t + 1], m - 1) + 1))
    assert not np.isnan(carry_val[carry_row >= 0]).any()
    for t in range(tiles):
        r = carry_row[2 * t + 1]
        if r < 0:
            continue
        total, u = carry_val[2 * t + 1], t + 1
        while u < tiles and carry_row[2 * u] == r:
            total += carry_val[2 * u]
            u += 1
        y[r] = total
        writes[r] += 1
    assert (writes == 1).all(), np.flatnonzero(writes != 1)
    return y


def walk_coo(row, col, val, x, m, vpt, zero_fill):
    """csrc/coo_spmv.cu in numpy, lane by lane: each lane's run, the
    segmented scan of the lanes' tails, the chunk's writes and carries,
    then the fold.  A run of empty rows longer than GAP_ROWS is left to the
    plan's zero fill.  Asserts that every row is written exactly once, the
    fill counted as a write."""
    nnz = len(row)
    chunks = -(-nnz // (32 * vpt))
    prod = val * x[col]
    y, writes = np.full(m, np.nan), np.zeros(m, np.int64)
    carry_row = np.full(2 * chunks, -7)
    carry_val = np.full(2 * chunks, np.nan)

    def put(r, v):
        y[r] = v
        writes[r] += 1

    def zero(lo, hi):
        if hi - lo > GAP_ROWS:
            assert zero_fill, (lo, hi)
        for z in range(lo, hi):
            put(z, 0.0)

    def carry(slot, r, v):
        assert carry_row[slot] == -7, "a carry slot written twice"
        carry_row[slot], carry_val[slot] = r, v

    for w in range(chunks):
        begin, end = w * 32 * vpt, (w + 1) * 32 * vpt
        lanes = []
        for lane in range(32):
            e0 = begin + lane * vpt
            n_here = int(np.clip(nnz - e0, 0, vpt))
            first = cur = -1
            acc = head = 0.0
            closed = False
            for k in range(n_here):
                r = row[e0 + k]
                if r != cur:
                    if cur < 0:
                        first = r
                    else:
                        if closed:
                            put(cur, acc)
                        else:
                            head, closed = acc, True
                        zero(cur + 1, r)
                    cur, acc = r, 0.0
                acc += prod[e0 + k]
            lanes.append((first, cur, acc, head, closed, n_here))
        scan = []
        for lane, (_, cur, acc, *_rest) in enumerate(lanes):
            same = lane > 0 and lanes[lane - 1][1] == cur
            scan.append(acc + (scan[-1] if same else 0.0))
        chunk_first = lanes[0][0]
        for lane, (first, cur, acc, head, closed, n_here) in enumerate(lanes):
            if n_here == 0:
                continue
            if w == 0 and lane == 0:
                zero(0, first)
            v = scan[lane]
            if closed:
                total = head + (scan[lane - 1] if lane > 0
                                and lanes[lane - 1][1] == first else 0.0)
                if first == chunk_first:
                    carry(2 * w, first, total)
                else:
                    put(first, total)
            next_first = lanes[lane + 1][0] if lane < 31 else first
            if not (lane == 31 or next_first < 0):
                if next_first != cur:
                    if cur == chunk_first:
                        carry(2 * w, cur, v)
                    else:
                        put(cur, v)
                    zero(cur + 1, next_first)
                continue
            after = row[end] if end < nnz else m
            if cur == chunk_first:
                carry(2 * w, cur, v)
                carry(2 * w + 1, -1, 0.0)
            elif after == cur:
                carry(2 * w + 1, cur, v)
            else:
                put(cur, v)
                carry(2 * w + 1, -1, 0.0)
            if after != cur:
                zero(cur + 1, after)
    assert (carry_row >= -1).all(), "a carry slot left unwritten"
    for i in range(2 * chunks):
        r = carry_row[i]
        if r < 0:
            continue
        prev = carry_row[i - 1] if i >= 1 else -1
        if prev < 0 and i >= 2:
            prev = carry_row[i - 2]
        if prev == r:
            continue
        total = 0.0
        for j in range(i, 2 * chunks):
            if carry_row[j] == r:
                total += carry_val[j]
            elif carry_row[j] >= 0:
                break
        put(r, total)
    assert (writes == 1).all(), np.flatnonzero(writes != 1)
    return y


@pytest.mark.parametrize("name", list(PATTERNS))
def test_tile_row_is_searchsorted_over_indptr(name):
    S = _matrix(PATTERNS[name])
    fn = build_csr(from_scipy(S, "csr", dtype=torch.float64, device="cpu"),
                   {"block_size": BLOCK})
    a = fn.planned_arrays
    nnz = S.nnz
    tiles = max(1, -(-nnz // TILE))
    expect = np.searchsorted(S.indptr, np.arange(tiles + 1) * TILE, side="right") - 1
    assert fn.plan_stats["tile"] == TILE and fn.plan_stats["tiles"] == tiles
    assert a["tile_row"].dtype == torch.int32
    np.testing.assert_array_equal(a["tile_row"].numpy(), expect)
    assert a["carry_row"].shape == a["carry_val"].shape == (2 * tiles,)
    assert a["carry_val"].dtype == torch.float64
    assert a["col"].shape == a["val"].shape == a["row"].shape == (nnz,)


@pytest.mark.parametrize("name", list(PATTERNS))
def test_csr_tile_walk_matches_plain_and_scipy(name):
    S = _matrix(PATTERNS[name], seed=2)
    A = from_scipy(S, "csr", dtype=torch.float64, device="cpu")
    fn = build_csr(A, {"block_size": BLOCK})
    a = {k: v.numpy() for k, v in fn.planned_arrays.items()}
    x = _x(S.shape[1])
    y = walk_csr(a["indptr"], a["col"], a["val"], x, S.shape[0], a["tile_row"],
                 fn.plan_stats["tile"], a["split_tile"], a["split_row"])
    xt = torch.from_numpy(x)
    plain = csr_spmv_plain(fn.planned_arrays["row"], fn.planned_arrays["col"],
                           fn.planned_arrays["val"], xt, S.shape[0]).numpy()
    np.testing.assert_allclose(y, plain, **TOL)
    np.testing.assert_allclose(y, S @ x, **TOL)
    np.testing.assert_allclose(fn(xt).numpy(), S @ x, **TOL)


@pytest.mark.parametrize("r0", [1, 7, 40])
def test_short_rows_sum_alike_on_any_tiling(r0):
    """The mesh path plans each row band by itself, so its tiles fall
    elsewhere than the whole matrix's: a short row must come out bit for
    bit the same in both walks (the cut of a 13-entry row at a tile
    boundary would change its rounding)."""
    rng = np.random.RandomState(r0)
    lengths = rng.randint(0, 2 * SHORT, 300)
    lengths[::17] = 13
    S = _matrix(lengths, seed=r0)
    x = _x(S.shape[1])
    walks = []
    for part in (S, S[r0:]):
        fn = build_csr(from_scipy(part, "csr", dtype=torch.float64, device="cpu"),
                       {"block_size": BLOCK})
        a = {k: v.numpy() for k, v in fn.planned_arrays.items()}
        walks.append(walk_csr(a["indptr"], a["col"], a["val"], x, part.shape[0],
                              a["tile_row"], fn.plan_stats["tile"], a["split_tile"],
                              a["split_row"]))
    short = lengths[r0:] <= SHORT
    assert short.sum() > 100 and S.indptr[r0] % TILE   # the tiles fall elsewhere
    np.testing.assert_array_equal(walks[1][short], walks[0][r0:][short])
    np.testing.assert_allclose(walks[1], S[r0:] @ x, **TOL)


@pytest.mark.parametrize("vpt", [1, 3, 4, 16])
@pytest.mark.parametrize("name", [n for n in PATTERNS if n != "no entries"])
def test_coo_chunk_walk_matches_plain_and_scipy(name, vpt):
    S = _matrix(PATTERNS[name], seed=3)
    fn = build_colsort(from_scipy(S, "coo", dtype=torch.float64, device="cpu"),
                       {"values_per_thread": vpt})
    a = fn.planned_arrays
    x = _x(S.shape[1])
    y = walk_coo(*(a[k].numpy() for k in ("row", "col", "val")), x, S.shape[0], vpt,
                 fn.plan_stats["zero_fill"])
    plain = coo_spmv_plain(a["row"], a["col"], a["val"], torch.from_numpy(x),
                           S.shape[0]).numpy()
    np.testing.assert_allclose(y, plain, **TOL)
    np.testing.assert_allclose(y, S @ x, **TOL)


@pytest.mark.parametrize("vpt,store,acc", [(1, "none", torch.float32),
                                           (4, "bfloat16", torch.float32),
                                           (16, "none", torch.float64)])
def test_colsort_plans_two_carries_a_chunk(vpt, store, acc):
    dtype = torch.float64 if acc == torch.float64 else torch.float32
    S = _matrix(PATTERNS["a row over more than 3 tiles"])
    fn = build_colsort(from_scipy(S, "csr", dtype=dtype, device="cpu"),
                       {"values_per_thread": vpt, "value_dtype": store})
    a = fn.planned_arrays
    chunks = -(-S.nnz // (32 * vpt))
    assert a["carry_row"].shape == a["carry_val"].shape == (2 * chunks,)
    assert a["carry_row"].dtype == torch.int32 and a["carry_val"].dtype == acc


@pytest.mark.parametrize("where", ["start", "middle", "end"])
@pytest.mark.parametrize("run", [GAP_ROWS, GAP_ROWS + 1])
def test_colsort_zero_fills_past_runs_of_gap_rows(where, run):
    """The kernel writes runs of at most GAP_ROWS empty rows itself; a plan
    with a longer run zero-fills y, and no other plan does."""
    lengths = {"start": [0] * run + [3, 1, 2], "middle": [3] + [0] * run + [1, 2],
               "end": [3, 1, 2] + [0] * run}[where]
    S = _matrix(lengths, seed=5)
    fn = build_colsort(from_scipy(S, "csr", dtype=torch.float64, device="cpu"), {})
    row = fn.planned_arrays["row"]
    assert longest_gap(row, S.shape[0]) == run
    assert fn.plan_stats["zero_fill"] == (run > GAP_ROWS)


@pytest.mark.parametrize("name", list(PATTERNS))
def test_tile_splits_cut_each_tiles_rows_into_tiles_worth(name):
    """Each tile's rows, tile_row[t] (0 for the first) to min(tile_row[t +
    1], m - 1), cut in order into parts of TILE rows: the first part is
    block t's, each later one a split (its tile and first row)."""
    S = _matrix(PATTERNS[name])
    m = S.shape[0]
    fn = build_csr(from_scipy(S, "csr", dtype=torch.float64, device="cpu"),
                   {"block_size": BLOCK})
    a = fn.planned_arrays
    tile_row = a["tile_row"].numpy()
    expect_tile, expect_row = [], []
    for t in range(len(tile_row) - 1):
        lo, hi = (0 if t == 0 else tile_row[t]), min(tile_row[t + 1], m - 1)
        starts = list(range(lo, hi + 1, TILE))[1:]
        expect_tile += [t] * len(starts)
        expect_row += starts
    assert a["split_tile"].dtype == a["split_row"].dtype == torch.int32
    np.testing.assert_array_equal(a["split_tile"].numpy(), expect_tile)
    np.testing.assert_array_equal(a["split_row"].numpy(), expect_row)
    assert fn.plan_stats["blocks"] == len(tile_row) - 1 + len(expect_tile)
    st, sr = tile_splits(a["tile_row"], m, TILE)
    assert torch.equal(st, a["split_tile"]) and torch.equal(sr, a["split_row"])
