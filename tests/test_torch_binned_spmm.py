"""The binned SpMM (csrc/binned_spmm.cu) walked in numpy on the CPU: the
colsort2 and routed SpMMs' row walk (csrc/rail_spmm.cuh) with kPerm, slot s
of the grid walking row rows[s] of the plan's walk list (`spmm_walk`: the
rows of at most spmm_cap entries, bin by bin, the bins of most lanes a row
first) over its entries [bounds[s][0], bounds[s][1]), one plane, then the
colsort2 hub pair for the rows above spmm_cap.

The kernel runs only on the card; what it reads and writes follows from the
plan (`plan_bins`, the walk list, the hub region) and from `spmm_schedule`
(kernels/dia.py).
So the tests walk its algorithm over the grid it is launched on: each
warp's G teams on G consecutive slots, the main rows' entries loaded
packed, by one offset where every team with entries starts at the same
offset from its packed start (gapless) or else by the search over the
teams' starts, each team's sum in entry order.  Every row above spmm_cap
is left to the hub pair and every other row is written once by the walk; the
f64 walk equals the plain version within 1e-12; the f32 walk equals
routed's one-plane walk bit for bit on a matrix with sorted columns at the
same threshold, whatever threads_per_row; the plain version equals the JAX
package's binned SpMM (interpret mode, as its own tests run it) at rtol
1e-4, atol 1e-4.  tests/test_torch_cuda.py holds the kernel itself to the
plain version and to the routed SpMM on the card."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch import gallery
from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels.binned import (
    HUB_CAP, binned_spmv_plain, build_binned,
)
from cusp_autotuned_tpu_torch.kernels.colsort2 import auto_hub_cap
from cusp_autotuned_tpu_torch.kernels.dia import spmm_schedule
from cusp_autotuned_tpu_torch.kernels.routed import build_routed

from tests.test_torch_rail_redesign import NO_PLANES
from tests.test_torch_spmm_rails import JAX_TOL, _jax_case, _matrix
from tests.test_torch_spmm_redesign import fma, walk_colsort2
from tests.torch_parity import one_thread, port_of  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)
INT_MAX = 2**31 - 1
TPR = [0, 1, 4]


def walk_binned_spmm(fn, X, align=16):
    """binned_spmm_walk_kernel and the colsort2 hub pair in numpy, X at
    `align` bytes: returns (Y, the walk's writes of each element, the hub
    pair's, {"gapless": warps, "search": warps} of the first column tile)."""
    a, st = fn.planned_arrays, fn.plan_stats
    indptr = a["indptr"].numpy().astype(np.int64)
    col, val = a["col"].numpy(), a["val"].numpy()
    walk, bounds = (t.numpy().astype(np.int64) for t in a["walk"])
    hub_rows = a["hub"][0].numpy()
    assert np.array_equal(bounds, np.stack([indptr[walk], indptr[walk + 1]], 1))
    assert (np.diff(bounds, axis=1) <= st["spmm_cap"]).all()
    W, C, _, shift = spmm_schedule(X.shape[1], align, X.itemsize)
    T, G = 1 << shift, 32 >> shift
    m, k = indptr.size - 1, X.shape[1]
    slots = walk.size
    Y = np.full((m, k), np.nan, X.dtype)
    walked = np.zeros((m, k), np.int64)
    paths = {"gapless": 0, "search": 0}
    for tile in range(-(-k // (T * C))):
        cols = np.arange(tile * T * C, (tile + 1) * T * C)
        cols = cols[cols < k]
        for w in range(-(-slots // G)):
            s = w * G + np.arange(G)
            have = s < slots
            rows = np.where(have, walk[np.minimum(s, slots - 1)], 0)
            start = np.where(have, bounds[np.minimum(s, slots - 1), 0], 0)
            length = np.where(have, bounds[np.minimum(s, slots - 1), 1] - start, 0)
            ls = length                      # every listed row is the walk's
            first = np.cumsum(ls) - ls
            total = int(ls.sum())
            d = (start - first)[ls > 0]
            s0 = int(d.min()) if d.size else INT_MAX
            gapless = bool((d == s0).all())
            if tile == 0 and total:
                paths["gapless" if gapless else "search"] += 1
            acc = [np.zeros(cols.size, X.dtype) for _ in range(G)]
            seen = [[] for _ in range(G)]
            for base in range(0, total, 128):
                slot_entry = {}
                for i in range(base, min(base + 128, total)):   # lane (i - base) % 32
                    t, step = 0, G >> 1
                    while step:
                        if first[t + step] <= i:
                            t += step
                        step >>= 1
                    slot_entry[i] = s0 + i if gapless else start[t] + i - first[t]
                for t in range(G):
                    for i in range(max(first[t], base), min(first[t] + ls[t], base + 128)):
                        e = slot_entry[i]
                        seen[t].append(e)
                        acc[t] = fma(np.asarray(val[e]), X[col[e], cols], acc[t])
            for t in np.flatnonzero(have):
                assert seen[t] == list(range(start[t], start[t] + length[t]))
                Y[rows[t], cols] = np.zeros(cols.size, X.dtype) + acc[t]
                walked[rows[t], cols] += 1
    # the hub pair: walk_colsort2 with no main row
    Yh, folded = walk_colsort2(indptr, col, val, X, [t.numpy() for t in a["hub"]],
                               NO_PLANES, -1, (W, C, None, shift))
    Y[hub_rows] = Yh[hub_rows]
    return Y, walked, folded, paths


def _powerlaw(n=300, seed=11):
    """Pareto row lengths of 1 to 60 entries, columns sorted in each row;
    about a third of the entries in rows above 8 (routed's tail at hub_cap 8
    holds at most half)."""
    rng = np.random.RandomState(seed)
    return _matrix(np.minimum(1 + (1.5 * rng.pareto(1.5, n)).astype(np.int64), 60),
                   seed=seed, n=400)


def _all_hub(n=120):
    """tests/test_pallas.py:489's matrix: 2-3 entries a row."""
    return _matrix([2] + [3] * (n - 2) + [2], seed=5, n=n)


def _interleaved():
    """Row lengths that bins by length scatter: each bin's rows lie far apart
    in storage, with runs of like rows between."""
    return _matrix(([3, 9, 1, 17, 5, 0, 33, 2] * 20 + [4] * 70 + [70, 12] * 10),
                   seed=6, n=300)


CASES = {  # (scipy matrix, hub_cap)
    "poisson5pt 40x10": (lambda: gallery.poisson5pt(40, 10, dtype=torch.float64,
                                                    device="cpu"), 0),
    "power-law hub_cap 8": (_powerlaw, 8),
    "all-hub hub_cap 1": (_all_hub, 1),
    "interleaved lengths hub_cap 24": (_interleaved, 24),
}


def _plan(case, tpr, dtype=torch.float64):
    make, hub_cap = CASES[case]
    A = make()
    if sp.issparse(A):
        A = from_scipy(A, "csr", dtype=dtype, device="cpu")
    return A, build_binned(A, {"threads_per_row": tpr, "hub_cap": hub_cap})


@pytest.mark.parametrize("k", [3, 33])
@pytest.mark.parametrize("tpr", TPR)
@pytest.mark.parametrize("case", list(CASES))
def test_walk_writes_every_row_once_and_matches_plain(case, tpr, k):
    """Each row of at most hub_cap entries written once by the walk, in
    entry order, no hub row touched by it; each hub row once by the fold;
    the f64 Y equal to the plain version.  With the rows binned by length
    and several teams a warp, the warps take both loads: by one offset and
    by the search."""
    A, fn = _plan(case, tpr)
    a, st = fn.planned_arrays, fn.plan_stats
    lengths = np.diff(a["indptr"].numpy())
    hub = lengths > st["spmm_cap"]
    assert st["spmm_cap"] == min(st["hub_cap"], auto_hub_cap(A.nnz, A.num_rows))
    assert st["spmm_hub_rows"] == hub.sum()
    X = np.random.RandomState(k).randn(A.num_cols, k)
    Y, walked, folded, paths = walk_binned_spmm(fn, X)
    assert (walked[~hub] == 1).all() and (walked[hub] == 0).all()
    assert (folded[hub] == 1).all() and (folded[~hub] == 0).all()
    plain = binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"], a["bins"],
                              torch.from_numpy(X), A.num_rows).numpy()
    np.testing.assert_allclose(Y, plain, **TOL)
    teams = 32 >> spmm_schedule(k, 16, X.itemsize)[3]
    if case == "all-hub hub_cap 1":
        assert hub.all() and paths == {"gapless": 0, "search": 0}
    elif teams == 1:                       # a row a warp: always one offset
        assert paths["search"] == 0, paths
    elif tpr == 0:                         # bins scatter the rows
        assert paths["search"] > 0, paths
        assert paths["gapless"] > 0 or case == "power-law hub_cap 8", paths
    elif case == "poisson5pt 40x10":       # row order, no hub row: one offset
        assert paths["search"] == 0, paths


@pytest.mark.parametrize("tpr", TPR)
@pytest.mark.parametrize("k", [3, 5, 16, 33, 130])
def test_f32_walk_equals_routed_one_plane_walk(k, tpr):
    """On a matrix with sorted columns, the binned SpMM's Y equals the
    routed SpMM's (rail_spmm.cuh with one plane in row order, the same hub
    pair) bit for bit at the same hub_cap: each row's sum is serial in
    entry order whatever the bin order, k, C or X's alignment."""
    S = _powerlaw(seed=12).astype(np.float32)
    A = from_scipy(S, "csr", dtype=torch.float32, device="cpu")
    fb = build_binned(A, {"threads_per_row": tpr, "hub_cap": 8})
    fr = build_routed(A, {"hub_cap": 8})
    r = fr.planned_arrays
    assert fb.plan_stats["hub_rows"] > 0
    assert all(torch.equal(p, q) for p, q in zip(fb.planned_arrays["hub"], r["hub"]))
    X = np.random.RandomState(k + 1).randn(S.shape[1], k).astype(np.float32)
    Yr, _ = walk_colsort2(r["indptr"].numpy(), r["col"].numpy(), r["val"].numpy(), X,
                          [t.numpy() for t in r["hub"]], NO_PLANES, 8,
                          spmm_schedule(k, 16, 4))
    for align in (16, 4):
        Y, _, _, _ = walk_binned_spmm(fb, X, align)
        assert np.array_equal(Y, Yr)


@pytest.mark.parametrize("tpr", TPR)
def test_bins_set_the_walk_order(tpr):
    """threads_per_row 0 lists the walk's rows bin by bin, the bins of most
    lanes a row (the longest rows) first, each bin in row order; 1 and 4
    keep row order; the rows above spmm_cap are left out, and they alone."""
    S = _interleaved()
    fn = build_binned(from_scipy(S, "csr", dtype=torch.float64, device="cpu"),
                      {"threads_per_row": tpr, "hub_cap": 24})
    walk = fn.planned_arrays["walk"][0].numpy()
    lengths = np.diff(S.indptr)
    assert np.array_equal(np.sort(walk), np.flatnonzero(lengths <= 24))
    if tpr:
        assert np.array_equal(walk, np.sort(walk))
    else:
        group = [g for start, count, g in fn.plan_stats["bins"]
                 for _ in range(count)]
        group_of = dict(zip(fn.planned_arrays["perm"].tolist(), group))
        order = [group_of[r] for r in walk.tolist()]
        assert order == sorted(order, reverse=True) and len(set(order)) > 2
        for g in set(order):
            rows = walk[np.array(order) == g]
            assert np.array_equal(rows, np.sort(rows))


@pytest.mark.parametrize("case", ["poisson5pt 40x10", "power-law hub_cap 8"])
def test_spmm_threshold_is_the_rails_below_hub_cap(case):
    """The walk takes rows up to min(hub_cap, max(64, 4 nnz / m)): at the
    default hub_cap (1024) the rails' threshold, the routed plan's default,
    and the same hub region as routed's."""
    A, fn = _plan(case, 0)
    cap = auto_hub_cap(A.nnz, A.num_rows)
    st = fn.plan_stats
    assert st["hub_cap"] == (HUB_CAP if case.startswith("poisson") else 8)
    assert st["spmm_cap"] == min(st["hub_cap"], cap)
    if case.startswith("poisson"):
        fr = build_routed(A, {})
        assert fr.plan_stats["hub_cap"] == st["spmm_cap"] == 64
        assert all(torch.equal(p, q) for p, q in
                   zip(fn.planned_arrays["hub"], fr.planned_arrays["hub"]))


@pytest.mark.parametrize("k", [3, 16])
def test_plain_matches_jax(k):
    """binned_spmv_plain with a hub row (hub_cap 32) against the JAX
    package's binned SpMM."""
    J, X, ref = _jax_case("binned", k)
    fn = build_binned(port_of(J), {"hub_cap": 32})
    assert fn.plan_stats["hub_rows"] == 1
    np.testing.assert_allclose(fn(torch.from_numpy(X)).numpy(), ref, **JAX_TOL)
