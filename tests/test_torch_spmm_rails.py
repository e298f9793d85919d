"""The routed SpMM's walk (csrc/rail_spmm.cuh, shared with the colsort2
SpMM) and the binned SpMV's schedule (csrc/binned_spmv.cu), walked in
numpy on the CPU.

The kernels run only on the card; what they read and write follows from
their plans and from `spmm_schedule` (kernels/dia.py).  So the tests walk
each kernel's algorithm over the grid it is launched on.  The SpMM walk is
the colsort2 SpMM's (tests/test_torch_spmm_redesign.py's walk_colsort2:
each warp's G teams, a team a row, the main rows' entries loaded packed,
each team's sum in entry order) with one plane, then the hub virtual rows
and their fold.  The binned SpMV: a lane a row of at most 32 entries
(tests/test_torch_rail_redesign.py's walk of csrc/rail_rows.cuh), a warp a
longer row up to hub_cap, a block a hub row.  Every row is written once,
in an order fixed by the row alone; the f64 walks equal the plain versions
within 1e-12; the f32 routed walk equals the one-plane colsort2 walk bit
for bit on every load path, and a binned band the whole walk; the plain
versions equal the JAX package's functions (run as its own tests run
them, interpret mode) at rtol 1e-4, atol 1e-4.  tests/test_torch_cuda.py
holds the kernels themselves to the plain versions on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_binned import build_binned as jax_binned
from cusp_autotuned_tpu.kernels.pallas_routed import build_routed as jax_routed

from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels.binned import (
    HUB_CAP, binned_spmv_plain, build_binned, spmv_rows,
)
from cusp_autotuned_tpu_torch.kernels.colsort2 import SHORT_ROW, build_colsort2
from cusp_autotuned_tpu_torch.kernels.dia import spmm_schedule
from cusp_autotuned_tpu_torch.kernels.routed import build_routed, routed_spmv_plain

from tests.test_torch_rail_redesign import NO_PLANES, tree32, walk as rail_walk
from tests.test_torch_spmm_redesign import walk_colsort2
from tests.torch_parity import one_thread, port_of  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_pallas.py:161
KS = [1, 3, 5, 16, 33, 130]


def _matrix(lengths, seed=0, n=700):
    """A seeded scipy CSR matrix with the given row lengths, columns drawn
    without repeats in each row and sorted."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    n = max(n, int(lengths.max(initial=0)))
    indptr = np.r_[0, np.cumsum(lengths)]
    col = np.concatenate([np.sort(rng.choice(n, k, replace=False)) for k in lengths]
                         + [np.zeros(0, np.int64)])
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


# rows of every class in one warp and across warps: short, long, hub and
# empty rows, and a warp of like-length long rows
LENGTHS = (list(np.random.RandomState(3).randint(0, 40, 90)) + [0, 0, 90, 1, 17]
           + [40] * 8 + [0] * 11 + [3])


def _block(n, k, dtype=np.float64, seed=17):
    return np.random.RandomState(seed).randn(n, k).astype(dtype)


def _routed(S, cfg, X, align=16):
    """(plan, Y, writes) of the routed SpMM walk on S in X's dtype, X at
    `align` bytes."""
    dtype = torch.float64 if X.dtype == np.float64 else torch.float32
    fn = build_routed(from_scipy(S, "csr", dtype=dtype, device="cpu"), cfg)
    a, st = fn.planned_arrays, fn.plan_stats
    Y, writes = walk_colsort2(a["indptr"].numpy(), a["col"].numpy(),
                              a["val"].numpy(), X, [t.numpy() for t in a["hub"]],
                              NO_PLANES, st["hub_cap"],
                              spmm_schedule(X.shape[1], align, X.itemsize))
    return fn, Y, writes


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("hub_cap", [0, 32])
def test_routed_walk_writes_every_row_once_in_entry_order(hub_cap, k):
    """Every element written once (a main row by its team, in entry order,
    a hub row by the fold), the f64 walk equal to the plain version; the
    4-byte path's bits equal the 16-byte path's."""
    S = _matrix(LENGTHS, seed=4)
    X = _block(S.shape[1], k)
    fn, Y, writes = _routed(S, {"hub_cap": hub_cap}, X)
    a, st = fn.planned_arrays, fn.plan_stats
    assert (writes == 1).all() and st["tail"] > 0
    plain = routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                              torch.from_numpy(X), S.shape[0], st["hub_cap"]).numpy()
    np.testing.assert_allclose(Y, plain, **TOL)
    _, Y4, _ = _routed(S, {"hub_cap": hub_cap}, X, align=4)
    assert np.array_equal(Y4, Y)


@pytest.mark.parametrize("k", [3, 16])
def test_routed_walk_is_colsort2_with_one_plane(k):
    """The f32 routed walk equals the colsort2 walk with one plane of
    hub_cap entries bit for bit: one plan (rows, hub region) and one
    walk."""
    S = _matrix(LENGTHS, seed=5).astype(np.float32)
    X = _block(S.shape[1], k, np.float32)
    fn, Y, _ = _routed(S, {"hub_cap": 32}, X)
    cap = fn.plan_stats["hub_cap"]
    A = from_scipy(S, "csr", dtype=torch.float32, device="cpu")
    c2 = build_colsort2(A, {"vrow_planes": 1, "vrow_len": cap, "hub_cap": cap})
    a, st = c2.planned_arrays, c2.plan_stats
    assert st["thr"] == st["vrow_len"] == cap
    assert all(torch.equal(p, q) for p, q in zip(a["hub"], fn.planned_arrays["hub"]))
    Yc, _ = walk_colsort2(a["indptr"].numpy(), a["col"].numpy(), a["val"].numpy(), X,
                          [t.numpy() for t in a["hub"]], st["vrow_len"], st["thr"],
                          spmm_schedule(k, 16, 4))
    assert np.array_equal(Yc, Y)


@pytest.mark.parametrize("window", [4096, 8192, 16384, 1000])
def test_routed_plan_carries_no_windows(window):
    """The SpMM reads every row of X through L1/L2: the plan holds the CSR
    arrays, the hub region and the long rows, whatever the window key (a
    TPU key, ignored)."""
    S = _matrix(LENGTHS, seed=7)
    A = from_scipy(S, "csr", dtype=torch.float64, device="cpu")
    base = build_routed(A, {"hub_cap": 32})
    got = build_routed(A, {"hub_cap": 32, "window": window})
    assert set(got.planned_arrays) == {"indptr", "col", "val", "hub", "long"}
    assert got.plan_stats == base.plan_stats and "window" not in got.plan_stats
    for key in ("indptr", "col", "val", "long"):
        assert torch.equal(got.planned_arrays[key], base.planned_arrays[key])


def _hub_block(indptr, prod, r, block):
    """binned_spmv.cu's hub_row: thread t sums entries t, t + B, ... in
    order, a shuffle tree a warp, the warps' sums in order."""
    s, L = indptr[r], indptr[r + 1] - indptr[r]
    steps = -(-L // block)
    lanes = np.zeros(block * steps, prod.dtype)
    lanes[:L] = prod[s:s + L]
    acc = np.zeros(block, prod.dtype)
    for i in range(steps):
        acc = (acc + lanes[i * block:(i + 1) * block]).astype(prod.dtype)
    total = prod.dtype.type(0)
    for w in range(block // 32):
        total = prod.dtype.type(total + tree32(acc[32 * w:32 * (w + 1)]))
    return total


def walk_binned(fn, x, dtype=np.float64, block=256):
    """binned_spmv.cu in numpy: the short and long rows as rail_rows.cuh
    walks them (one plane, hub_cap the threshold), then each hub row by a
    block.  Returns (y, writes)."""
    a, st = fn.planned_arrays, fn.plan_stats
    indptr, col, val = (a[k].numpy() for k in ("indptr", "col", "val"))
    long, hubs = (t.numpy() for t in a["spmv_rows"])
    y, writes = rail_walk(indptr, col, val, x, st["hub_cap"], NO_PLANES, long, block,
                          dtype=dtype)
    prod = (np.asarray(val, dtype) * np.asarray(x, dtype)[col]).astype(dtype)
    for r in hubs:
        y[r] = _hub_block(np.asarray(indptr, np.int64), prod, r, block)
        writes[r] += 1
    return y, writes


@pytest.mark.parametrize("hub_cap,tpr", [(0, 0), (64, 0), (24, 4), (16, 1)])
def test_binned_walk_writes_every_row_once_and_matches_plain(hub_cap, tpr):
    """A lane, a warp or a block a row by its length alone: the plan's
    threads_per_row shapes the SpMM's bins, not the SpMV's rows."""
    S = _matrix(LENGTHS + [1500, 70, 2100], seed=8, n=2500)
    A = from_scipy(S, "csr", dtype=torch.float64, device="cpu")
    fn = build_binned(A, {"hub_cap": hub_cap, "threads_per_row": tpr})
    st = fn.plan_stats
    cap = hub_cap or HUB_CAP
    lengths = np.diff(S.indptr)
    assert st["hub_cap"] == cap and st["hub_rows"] == (lengths > cap).sum()
    assert st["long_rows"] == ((lengths > SHORT_ROW) & (lengths <= cap)).sum()
    x = np.random.RandomState(1).randn(S.shape[1])
    y, writes = walk_binned(fn, x)
    assert (writes == 1).all()
    a = fn.planned_arrays
    plain = binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"], a["bins"],
                              torch.from_numpy(x), S.shape[0]).numpy()
    np.testing.assert_allclose(y, plain, **TOL)
    np.testing.assert_allclose(y, S @ x, **TOL)


def test_binned_rows_start_longest_first():
    """The warp rows and the block rows are listed longest first, so that
    the launch's first blocks take the longest sums."""
    lengths = np.array([33, 5, 900, 1025, 64, 3000, 40, 1024, 2000, 0])
    long, hubs = spmv_rows(np.r_[0, np.cumsum(lengths)])
    assert long.tolist() == [7, 2, 4, 6, 0] and hubs.tolist() == [5, 8, 3]
    assert long.dtype == hubs.dtype == np.int32


def test_binned_f32_walk_of_a_band_equals_the_whole_walk():
    """Rows 20..119 planned alone give the whole plan's sums on those rows bit
    for bit: each row's order is fixed by the row and the block size."""
    S = _matrix(LENGTHS + [1500, 70], seed=9, n=2000).astype(np.float32)
    x = np.random.RandomState(2).randn(S.shape[1]).astype(np.float32)
    whole = build_binned(from_scipy(S, "csr", dtype=torch.float32, device="cpu"),
                         {"hub_cap": 64})
    band = build_binned(from_scipy(S[20:120], "csr", dtype=torch.float32,
                                   device="cpu"), {"hub_cap": 64})
    y, _ = walk_binned(whole, x, np.float32)
    yb, _ = walk_binned(band, x, np.float32)
    assert np.array_equal(yb, y[20:120])


def _hub_row():
    """A 1000 x 1000 scatter of ~3 entries a row and a 300-entry row 7 (the
    shape of tests/test_pallas.py:835, smaller)."""
    rng = np.random.RandomState(3)
    S = sp.random(1000, 1000, density=3e-3, random_state=rng, dtype=np.float32)
    hub = sp.coo_matrix((rng.randn(300).astype(np.float32),
                         (np.full(300, 7), rng.choice(1000, 300, replace=False))),
                        shape=(1000, 1000))
    return (S + hub).tocsr()


@functools.cache
def _jax_case(rail, k):
    J = jax_from_scipy(_hub_row().tocoo(), "csr")
    shape = (J.num_cols,) if k == 0 else (J.num_cols, k)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    fn = (jax_routed if rail == "routed" else jax_binned)(J, {"hub_cap": 32},
                                                           interpret=True)
    y = jax.jit(fn)(jnp.asarray(x)) if k == 0 else fn(jnp.asarray(x))
    return J, x, np.asarray(y)


def test_routed_spmm_plain_matches_jax():
    """routed_spmv_plain at K > 0, the hub row in the tail, against the JAX
    package's routed SpMM."""
    J, X, ref = _jax_case("routed", 4)
    fn = build_routed(port_of(J), {"hub_cap": 32})
    assert fn.plan_stats["tail"] >= 300
    np.testing.assert_allclose(fn(torch.from_numpy(X)).numpy(), ref, **JAX_TOL)


@pytest.mark.parametrize("k", [0, 4])
def test_binned_plain_matches_jax(k):
    """binned_spmv_plain, the plain version of both binned kernels, with a
    block row (hub_cap 32) against the JAX package's binned SpMV and SpMM."""
    J, x, ref = _jax_case("binned", k)
    fn = build_binned(port_of(J), {"hub_cap": 32})
    assert fn.plan_stats["hub_rows"] == 1
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref, **JAX_TOL)
