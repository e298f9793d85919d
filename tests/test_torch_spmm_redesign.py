"""The schedules of the DIA SpMM kernels (csrc/dia_spmm_body.cuh), the COO
SpMM kernel (csrc/coo_spmm.cu) and the colsort2 SpMM pair
(csrc/colsort2_spmm.cu), walked in numpy on the CPU.

The kernels run only on the card; what they read and write follows from
`spmm_schedule` (kernels/dia.py): the columns and rows a lane takes, its
load width and its team.  So the tests walk each kernel's algorithm over
the grid it is launched on: for DIA, each lane's R rows and C columns, the
rows of X kept in registers from one diagonal to the next, a band's base;
for COO, each warp's chunk, the entries its lanes load, the order in which
each team takes them from its lanes, the segmented scan over the teams, the
carries and their fold, and the empty rows the kernel writes itself; for
colsort2, each warp's rows, the main rows' entries its lanes load packed
(by offset, or by the search over the teams' starts where hub rows lie
between), each team's walk plane by plane, and the hub virtual rows and
their fold.  Every element of Y is written once, the f64 walks equal the
plain versions within 1e-12, an f32 walk equals the JAX package's function
(run as its own tests run it on the CPU) at rtol 1e-5, atol 1e-4, and the
band walk equals the whole matrix's walk bit for bit.  tests/test_torch_cuda.py holds the kernels
themselves to the plain versions on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_colsort import build_colsort as jax_colsort
from cusp_autotuned_tpu.kernels.pallas_colsort2 import build_colsort2 as jax_colsort2
from cusp_autotuned_tpu.kernels.pallas_dia import build_dia as jax_dia

from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels.colsort import (
    GAP_ROWS, build_colsort, coo_spmv_plain,
)
from cusp_autotuned_tpu_torch.kernels.colsort2 import (
    build_colsort2, colsort2_spmv_plain,
)
from cusp_autotuned_tpu_torch.kernels.dia import (
    NARROW, dia_band_spmv_plain, dia_spmv_plain, spmm_schedule,
)

from tests.torch_parity import one_thread, port_of  # noqa: F401

KS = [1, 3, 4, 5, 16, 33, 128, 130]
TOL = dict(rtol=1e-12, atol=1e-12)
JAX_TOL = dict(rtol=1e-5, atol=1e-4)
BLOCK = 128


def fma(a, x, acc):
    """acc + a x rounded once into acc's type (f64 holds an f32 product
    exactly)."""
    return (a.astype(np.float64) * x + acc).astype(acc.dtype)


def walk_dia(data, offsets, X, rows, sched, base=0, band=False, block=BLOCK):
    """dia_spmm_rows over the launch grid in numpy: returns (Y, writes of
    each element, loads of X rows a lane).  data (ndiag, >= rows); X the
    whole X (n, k), or X_pad where `band`, in the accumulation type."""
    W, C, R, shift = sched
    n, k = X.shape
    T = 1 << shift
    assert k % C == 0 and C % W == 0 and T <= 32
    blocks = -(-rows // ((block >> shift) * R))
    tiles = -(-k // (T * C))
    bx, ty, t = (a.ravel() for a in np.meshgrid(np.arange(blocks), np.arange(tiles),
                                                np.arange(block), indexing="ij"))
    i0 = (bx * (block >> shift) + (t >> shift)) * R
    c0 = ((ty << shift) + (t & (T - 1))) * C
    own = (i0 < rows) & (c0 < k)
    i0, c0 = i0[own], c0[own]
    lanes = i0.size
    cols = c0[:, None] + np.arange(C)
    acc = np.zeros((R, lanes, C), X.dtype)
    xr = np.zeros((R, lanes, C), X.dtype)
    held = np.full((R, lanes), -1 << 40)     # the row of X each register holds
    loads = np.zeros(lanes, np.int64)
    prev = 0
    for d, off in enumerate(offsets):
        keep = np.zeros(lanes, np.int64)
        s = off - prev
        if R > 1 and d > 0 and 0 < s < R:
            xr[:R - s], held[:R - s] = xr[s:].copy(), held[s:].copy()
            keep = np.clip(rows - i0 - s if band else np.full(lanes, R - s), 0, R - s)
        for r in range(R):
            i = i0 + r
            j = base + i + off
            load = i < rows if band else (j >= 0) & (j < n)
            fresh = (r >= keep) & load
            xr[r][fresh] = X[j[fresh][:, None], cols[fresh]]
            held[r][fresh] = j[fresh]
            loads += fresh
            add = (i < rows) & load
            assert (held[r][add] == j[add]).all(), "a kept row of X is not this row's"
            a = data[d, i[add]].astype(X.dtype)
            acc[r][add] = fma(a[:, None], xr[r][add], acc[r][add])
        prev = off
    Y = np.full((rows, k), np.nan, X.dtype)
    writes = np.zeros((rows, k), np.int64)
    for r in range(R):
        ok = i0 + r < rows
        Y[(i0 + r)[ok][:, None], cols[ok]] = acc[r][ok]
        np.add.at(writes, ((i0 + r)[ok][:, None], cols[ok]), 1)
    return Y, writes, loads


@functools.cache
def _poisson_dia():
    J = jgallery.poisson5pt(9, 11, format="dia", dtype=np.float32)
    return J, port_of(J)


def _block(n, k, seed=17, dtype=np.float32):
    return np.random.RandomState(seed).randn(n, k).astype(dtype)


@pytest.mark.parametrize("k", KS)
def test_dia_lanes_cover_every_element_once_and_match_plain(k):
    """Every alignment and R: the lane map writes each element of Y once,
    the f64 walk equals the plain version, and the kept rows of X save
    loads on the offsets -1, 0, +1."""
    _, A = _poisson_dia()
    data = A.data.double().numpy()
    X = _block(A.num_cols, k, dtype=np.float64)
    plain = dia_spmv_plain(A.data.double(), A.offsets, torch.from_numpy(X),
                           A.shape).numpy()
    for align in (16, 8, 4):
        for rows in (None, 1, 2, 4):
            sched = spmm_schedule(k, align, 4, rows)
            W, C, R, shift = sched
            assert W * 4 <= align and k % C == 0
            if k <= NARROW:
                assert (C, shift) == (k, 0)
            else:
                assert C == W and (1 << shift) == min(32, 1 << (-(-k // C) - 1)
                                                      .bit_length())
            Y, writes, loads = walk_dia(data, A.offsets, X, A.num_rows, sched)
            assert (writes == 1).all()
            np.testing.assert_allclose(Y, plain, **TOL)
            # interior lanes: 2 far rows R times, the cluster R + 2 rows
            full = loads.max()
            assert full == 2 * R + (R + 2 if R > 1 else 3)


@pytest.mark.parametrize("k", [3, 16, 130])
def test_dia_walk_is_the_same_on_every_path_and_r(k):
    """The sum of each element runs diagonal by diagonal whatever the width
    and R: the f32 walks agree bit for bit (the card test holds the
    kernels to the same)."""
    _, A = _poisson_dia()
    X = _block(A.num_cols, k)
    data = A.data.numpy()
    walks = [walk_dia(data, A.offsets, X, A.num_rows, spmm_schedule(k, a, 4, r))[0]
             for a in (16, 4) for r in (1, 2, 4)]
    for Y in walks[1:]:
        assert np.array_equal(Y, walks[0])


@pytest.mark.parametrize("k", [3, 16, 33])
def test_dia_band_walk_equals_the_whole_walk(k):
    """The band twin (base = left + row0, X_pad, no bounds test, no row
    read past the band) gives each band's rows of the whole walk bit for
    bit, on offsets whose gaps are 1 to 3 (so R = 4 shifts by each)."""
    offsets = [-7, -3, -1, 0, 1, 2, 5]
    m = n = 203
    rng = np.random.RandomState(3)
    data = rng.uniform(0.5, 2.0, (len(offsets), m)).astype(np.float32)
    X = _block(n, k)
    left = 7
    X_pad = np.concatenate([np.zeros((left, k), np.float32), X,
                            np.zeros((8, k), np.float32)])
    for R in (1, 2, 4):
        sched = spmm_schedule(k, 16, 4, R)
        whole = walk_dia(data, offsets, X, m, sched)[0]
        plain = dia_band_spmv_plain(torch.from_numpy(data.astype(np.float64)),
                                    offsets, torch.from_numpy(X_pad.astype(np.float64)),
                                    left, 0).numpy()
        np.testing.assert_allclose(whole, plain, rtol=1e-5, atol=1e-5)
        for row0, band in ((0, 50), (50, 67), (117, 86)):
            Y, writes, _ = walk_dia(data[:, row0:row0 + band], offsets, X_pad, band,
                                    sched, base=left + row0, band=True)
            assert (writes == 1).all()
            assert np.array_equal(Y, whole[row0:row0 + band])


@functools.cache
def _jax_dia(k):
    J, _ = _poisson_dia()
    X = _block(J.num_cols, k)
    return np.asarray(jax.jit(jax_dia(J, {"block_rows": 1024}, interpret=True))(
        jnp.asarray(X)))


@pytest.mark.parametrize("k", [3, 128])
def test_dia_walk_matches_jax(k):
    """The f32 walk against the JAX package's DIA SpMM (the XLA path at
    k = 3, the Pallas kernel at k = 128, interpret mode)."""
    _, A = _poisson_dia()
    Y, _, _ = walk_dia(A.data.numpy(), A.offsets, _block(A.num_cols, k), A.num_rows,
                       spmm_schedule(k, 16, 4))
    np.testing.assert_allclose(Y, _jax_dia(k), **JAX_TOL)


def walk_coo(row, col, val, X, m, vpt, sched, zero_fill):
    """coo_spmm_chunk_kernel and coo_spmm_fold_kernel in numpy: returns (Y,
    writes of each element by the kernels, times each entry was walked in
    each column tile)."""
    W, C, _, shift = sched
    T, G = 1 << shift, 32 >> shift
    nnz, k = row.size, X.shape[1]
    chunk = 32 * vpt
    nchunks = -(-nnz // chunk)
    tiles = -(-k // (T * C))
    Y = np.zeros((m, k), X.dtype) if zero_fill else np.full((m, k), np.nan, X.dtype)
    writes = np.zeros((m, k), np.int64)
    carry_row = np.full(2 * nchunks, -7)
    carry_val = np.full((2 * nchunks, k), np.nan, X.dtype)
    walked = np.zeros((tiles, nnz), np.int64)

    for tile in range(tiles):
        cols = np.arange(tile * T * C, (tile + 1) * T * C)
        cols = cols[cols < k]           # the lanes that are `mine`

        def store(r, v):
            Y[r, cols] = v
            writes[r, cols] += 1

        def zero_rows(lo, hi):
            if hi - lo <= GAP_ROWS:
                for z in range(lo, hi):
                    store(z, 0)

        for w in range(nchunks):
            begin = w * chunk
            teams = []
            for team in range(G):
                seg = begin + team * vpt * T
                seg_end = min(seg + vpt * T, nnz)
                first = cur = -1
                acc = np.zeros(cols.size, X.dtype)
                head = acc.copy()
                closed = False
                for b in range(0, vpt, 4):
                    # lane j of the team loads entries 4 j .. 4 j + 3 of the round
                    regs = [[e if e < seg_end else -1
                             for e in range(seg + b * T + 4 * j, seg + b * T + 4 * j + 4)]
                            for j in range(T)]
                    for j in range(T):      # the team takes them lane by lane
                        for e in regs[j]:
                            if e < 0:
                                break
                            walked[tile, e] += 1
                            r = row[e]
                            if r != cur:
                                if cur < 0:
                                    first = r
                                else:
                                    if not closed:
                                        head, closed = acc, True
                                    else:
                                        store(cur, acc)
                                    zero_rows(cur + 1, r)
                                cur, acc = r, np.zeros(cols.size, X.dtype)
                            acc = fma(np.asarray(val[e]), X[col[e], cols], acc)
                teams.append(dict(first=first, cur=cur, acc=acc, head=head,
                                  closed=closed))
            # the segmented scan over the teams, as the shuffles take it
            v = [t["acc"] for t in teams]
            off = 1
            while off < G:
                v = [v[t] + v[t - off] if t >= off and teams[t - off]["cur"] ==
                     teams[t]["cur"] else v[t] for t in range(G)]
                off <<= 1
            chunk_first = teams[0]["first"]
            for t, s in enumerate(teams):
                if s["first"] < 0:
                    continue
                if w == 0 and t == 0:
                    zero_rows(0, s["first"])
                if s["closed"]:
                    total = (s["head"] + v[t - 1] if t > 0 and
                             teams[t - 1]["cur"] == s["first"] else s["head"])
                    if s["first"] == chunk_first:
                        carry_row[2 * w] = s["first"]
                        carry_val[2 * w, cols] = total
                    else:
                        store(s["first"], total)
                nxt = teams[t + 1]["first"] if t + 1 < G else -1
                cur = s["cur"]
                if t < G - 1 and nxt >= 0:
                    if nxt != cur:
                        if cur == chunk_first:
                            carry_row[2 * w] = cur
                            carry_val[2 * w, cols] = v[t]
                        else:
                            store(cur, v[t])
                        zero_rows(cur + 1, nxt)
                    continue
                after = row[begin + chunk] if begin + chunk < nnz else m
                if cur == chunk_first:
                    carry_row[2 * w], carry_row[2 * w + 1] = cur, -1
                    carry_val[2 * w, cols] = v[t]
                elif after == cur:
                    carry_row[2 * w + 1] = cur
                    carry_val[2 * w + 1, cols] = v[t]
                else:
                    carry_row[2 * w + 1] = -1
                    store(cur, v[t])
                if after != cur:
                    zero_rows(cur + 1, after)
    assert (carry_row != -7).all(), "a carry slot was never written"
    for i, r in enumerate(carry_row):           # the fold, a slot at a time
        if r < 0:
            continue
        prev = carry_row[i - 1] if i >= 1 else -1
        if prev < 0 and i >= 2:
            prev = carry_row[i - 2]
        if prev == r:
            continue
        total = np.zeros(k, X.dtype)
        for j in range(i, carry_row.size):
            if carry_row[j] == r:
                total = total + carry_val[j]
            elif carry_row[j] >= 0:
                break
        Y[r] = total
        writes[r] += 1
    return Y, writes, walked


# row lengths: a row across many chunks, runs of empty rows of GAP_ROWS at
# the start, middle and end, and one run past it
COO_PATTERNS = {
    "a long row and short gaps":
        [0] * GAP_ROWS + [3, 700] + list(np.random.RandomState(5).randint(0, 9, 150))
        + [0] * 7 + [1, 2] + [0] * GAP_ROWS,
    "a run past GAP_ROWS": [2, 5] + [0] * (GAP_ROWS + 1) + [4] * 60 + [40, 1],
}


def _coo(lengths, seed=0, n=900):
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    indptr = np.r_[0, np.cumsum(lengths)]
    col = np.concatenate([np.sort(rng.choice(n, c, replace=False)) for c in lengths])
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(COO_PATTERNS))
def test_coo_walk_writes_every_row_once_and_matches_plain(name, k):
    """The f64 walk at vpt 4 and 1 and two alignments: every entry walked
    once a tile, every element of Y written once (only the long run left
    to the plan's zero fill), equal to the plain version."""
    S = _coo(COO_PATTERNS[name])
    A = from_scipy(S, "csr", dtype=torch.float64, device="cpu")
    X = _block(S.shape[1], k, dtype=np.float64)
    for vpt in (4, 1):
        fn = build_colsort(A, {"values_per_thread": vpt})
        a = fn.planned_arrays
        zero_fill = fn.plan_stats["zero_fill"]
        assert zero_fill == (name == "a run past GAP_ROWS")
        plain = coo_spmv_plain(a["row"], a["col"], a["val"], torch.from_numpy(X),
                               S.shape[0]).numpy()
        for align in (16, 4):
            Y, writes, walked = walk_coo(a["row"].numpy(), a["col"].numpy(),
                                         a["val"].numpy(), X, S.shape[0], vpt,
                                         spmm_schedule(k, align, 8), zero_fill)
            assert (walked == 1).all()
            lengths = np.diff(S.indptr)
            gap = np.zeros(S.shape[0], bool)
            if zero_fill:
                run = np.flatnonzero(lengths)
                for lo, hi in zip(run[:-1], run[1:]):
                    gap[lo + 1:hi] = hi - lo - 1 > GAP_ROWS
            assert (writes[~gap] == 1).all() and (writes[gap] == 0).all()
            np.testing.assert_allclose(Y, plain, **TOL)


@functools.cache
def _jax_coo(k):
    S = _coo(COO_PATTERNS["a long row and short gaps"], seed=1).astype(np.float32)
    J = jax_from_scipy(S.tocoo(), "csr")
    X = _block(S.shape[1], k)
    cfg = dict(block_entries=2048, col_window=2048, row_window=512, hub_cap=10)
    return S, X, np.asarray(jax.jit(jax_colsort(J, cfg, interpret=True))(
        jnp.asarray(X)))


@pytest.mark.parametrize("k", [3])
def test_coo_walk_matches_jax(k):
    """The f32 walk against the JAX package's colsort SpMM (main and hub
    Pallas kernels, interpret mode)."""
    S, X, ref = _jax_coo(k)
    A = from_scipy(S, "csr", dtype=torch.float32, device="cpu")
    fn = build_colsort(A, {})
    a = fn.planned_arrays
    Y, writes, _ = walk_coo(a["row"].numpy(), a["col"].numpy(), a["val"].numpy(), X,
                            S.shape[0], 4, spmm_schedule(k, 16, 4), False)
    assert (writes == 1).all()
    np.testing.assert_allclose(Y, ref, **JAX_TOL)


def walk_colsort2(indptr, col, val, X, hub, V, thr, sched):
    """colsort2_spmm_main_kernel, colsort2_spmm_hub_kernel and the hub fold
    in numpy: returns (Y, writes of each element)."""
    W, C, _, shift = sched
    T, G = 1 << shift, 32 >> shift
    indptr = np.asarray(indptr, np.int64)
    m, k = indptr.size - 1, X.shape[1]
    tiles = -(-k // (T * C))
    Y = np.full((m, k), np.nan, X.dtype)
    writes = np.zeros((m, k), np.int64)
    for tile in range(tiles):
        cols = np.arange(tile * T * C, (tile + 1) * T * C)
        cols = cols[cols < k]
        for w in range(-(-m // G)):
            rows = w * G + np.arange(G)
            have = rows < m
            start = np.where(have, indptr[np.minimum(rows, m - 1)], 0)
            length = np.where(have, indptr[np.minimum(rows, m - 1) + 1] - start, 0)
            main = have & (length <= thr)
            ls = np.where(main, length, 0)
            first = np.cumsum(ls) - ls
            total = int(ls.sum())
            gapless = not (have & ~main & (length > 0)).any()
            acc = [np.zeros(cols.size, X.dtype) for _ in range(G)]
            tot = [np.zeros(cols.size, X.dtype) for _ in range(G)]
            left, seen = [V] * G, [[] for _ in range(G)]
            for base in range(0, total, 128):
                slots = {}
                for i in range(base, min(base + 128, total)):   # lane (i - base) % 32
                    t = 0
                    step = G >> 1
                    while step:
                        if first[t + step] <= i:
                            t += step
                        step >>= 1
                    slots[i] = start[0] + i if gapless else start[t] + i - first[t]
                for t in range(G):
                    for i in range(max(first[t], base), min(first[t] + ls[t], base + 128)):
                        e = slots[i]
                        seen[t].append(e)
                        acc[t] = fma(np.asarray(val[e]), X[col[e], cols], acc[t])
                        left[t] -= 1
                        if left[t] == 0:
                            tot[t], acc[t], left[t] = tot[t] + acc[t], 0 * acc[t], V
            for t in np.flatnonzero(main):
                assert seen[t] == list(range(start[t], start[t] + length[t]))
                Y[rows[t], cols] = tot[t] + acc[t]
                writes[rows[t], cols] += 1
    rows, ptr, lo, hi = (np.asarray(a) for a in hub)
    part = np.zeros((lo.size, k), X.dtype)
    for v in range(lo.size):                    # T entries a round, in order
        for e in range(lo[v], hi[v]):
            part[v] = fma(np.asarray(val[e]), X[col[e]], part[v])
    for h, r in enumerate(rows):
        total = np.zeros(k, X.dtype)
        for v in range(ptr[h], ptr[h + 1]):
            total = total + part[v]
        Y[r] = total
        writes[r] += 1
    return Y, writes


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cfg", [{"vrow_planes": 2, "vrow_len": 8}, {},
                                 {"vrow_planes": 1, "hub_cap": 1}])
def test_colsort2_walk_writes_every_row_once_and_matches_plain(cfg, k):
    """Main rows and hub rows side by side, runs of empty rows, a long row:
    every element written once, the f64 walk equal to the plain version."""
    S = _coo(COO_PATTERNS["a long row and short gaps"], seed=4)
    A = from_scipy(S, "csr", dtype=torch.float64, device="cpu")
    fn = build_colsort2(A, cfg)
    a, st = fn.planned_arrays, fn.plan_stats
    X = _block(S.shape[1], k, dtype=np.float64)
    plain = colsort2_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                torch.from_numpy(X), S.shape[0], st["vrow_planes"],
                                st["vrow_len"], st["thr"]).numpy()
    for align in (16, 4):
        Y, writes = walk_colsort2(a["indptr"].numpy(), a["col"].numpy(),
                                  a["val"].numpy(), X, [t.numpy() for t in a["hub"]],
                                  st["vrow_len"], st["thr"], spmm_schedule(k, align, 8))
        assert (writes == 1).all()
        np.testing.assert_allclose(Y, plain, **TOL)


@functools.cache
def _jax_colsort2(k):
    S = _coo(COO_PATTERNS["a long row and short gaps"], seed=5).astype(np.float32)
    J = jax_from_scipy(S.tocoo(), "csr")
    X = _block(S.shape[1], k)
    return S, X, np.asarray(jax_colsort2(J, {"vrow_len": 8, "spmm_kb": 4},
                                         interpret=True)(jnp.asarray(X)))


def test_colsort2_walk_matches_jax():
    """The f32 walk at k = 3 against the JAX package's colsort2 SpMM (its
    Pallas kernel's SpMM site, interpret mode)."""
    S, X, ref = _jax_colsort2(3)
    A = from_scipy(S, "csr", dtype=torch.float32, device="cpu")
    fn = build_colsort2(A, {"vrow_len": 8})
    a, st = fn.planned_arrays, fn.plan_stats
    Y, writes = walk_colsort2(a["indptr"].numpy(), a["col"].numpy(), a["val"].numpy(),
                              X, [t.numpy() for t in a["hub"]], st["vrow_len"],
                              st["thr"], spmm_schedule(3, 16, 4))
    assert (writes == 1).all()
    np.testing.assert_allclose(Y, ref, **JAX_TOL)
