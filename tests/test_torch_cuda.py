"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA device.
The module imports neither JAX nor the JAX package, so that it also runs on
a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets up JAX.)  The tolerances are
the reference's own for its DIA, CSR and lane-binned kernels
(tests/test_pallas.py:22, :97 and :161)."""

import functools
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch import eigen, gallery, solvers
from cusp_autotuned_tpu_torch.autotune import ResultStatus, Tuner, calibrate
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.kernels import build_spmv, default_config
from cusp_autotuned_tpu_torch.kernels.binned import (
    binned_spmm, binned_spmv, binned_spmv_plain, build_binned,
)
from cusp_autotuned_tpu_torch.kernels.colsort import (
    build_colsort, coo_spmm, coo_spmv, coo_spmv_plain,
)
from cusp_autotuned_tpu_torch.kernels.colsort2 import (
    build_colsort2, colsort2_hub, colsort2_hub_spmm, colsort2_spmm, colsort2_spmv,
    colsort2_spmv_plain,
)
from cusp_autotuned_tpu_torch.kernels.csr import (
    ENTRIES_PER_THREAD, build_csr, csr_spmv, csr_spmv_plain,
)
from cusp_autotuned_tpu_torch.kernels.dia import (
    build_dia, dia_spmm, dia_spmv, dia_spmv_plain,
)
from cusp_autotuned_tpu_torch.kernels.routed import (
    build_routed, routed_spmm, routed_spmv, routed_spmv_plain,
)
from cusp_autotuned_tpu_torch.operators import planned_operator
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

pytestmark = pytest.mark.cuda

TOL = {"dia": dict(rtol=1e-5, atol=1e-4), "csr": dict(rtol=1e-4, atol=1e-4),
       "rails": dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _skewed(n, seed):
    """A seeded scipy matrix whose row lengths follow a heavy-tailed law
    (1 to 64 entries a row), as tests/torch_parity.py builds for the parity
    tests; a GPU machine may not find the `tests` directory as a package."""
    rng = np.random.RandomState(seed)
    lengths = np.minimum(1 + rng.pareto(1.5, n).astype(np.int64), 64)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    return sp.csr_matrix((rng.uniform(-1.0, 1.0, indptr[-1]),
                          rng.randint(0, n, indptr[-1]), indptr), shape=(n, n))


def _x(n, device, dtype=torch.float32, seed=3):
    x = np.random.RandomState(seed).randn(n)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _dia_case(A, config, device):
    """(kernel y, plain y, launches of this call) for a DIA matrix A."""
    fn = build_dia(A, config)
    x = _x(A.num_cols, device, A.dtype if A.dtype == torch.float64 else torch.float32)
    before = dia_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    yp = dia_spmv_plain(fn.planned_arrays["data"], A.offsets, x, A.shape)
    return y, yp, dia_spmv.launches - before


def _csr_case(A, config, device):
    """(kernel y, plain y, launches of this call) for a CSR matrix A."""
    fn = build_csr(A, config)
    x = _x(A.num_cols, device, A.dtype if A.dtype == torch.float64 else torch.float32)
    before = csr_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    a = fn.planned_arrays
    yp = csr_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows)
    return y, yp, csr_spmv.launches - before


@pytest.mark.parametrize("value_dtype", ["none", "bfloat16"])
def test_dia_kernel_matches_plain_on_card(cuda_device, value_dtype):
    A = gallery.poisson5pt(300, 200, format="dia", device=cuda_device)
    assert default_config(A)["impl"] == "cuda"
    y, yp, launches = _dia_case(A, {"value_dtype": value_dtype}, cuda_device)
    assert launches == 1
    torch.testing.assert_close(y, yp, **TOL["dia"])


@pytest.mark.parametrize("value_dtype", ["none", "bfloat16"])
def test_csr_kernel_matches_plain_on_card(cuda_device, value_dtype):
    A = from_scipy(_skewed(20000, 8), "csr", dtype=torch.float32,
                   device=cuda_device)
    assert default_config(A)["impl"] == "cuda"
    y, yp, launches = _csr_case(A, {"value_dtype": value_dtype}, cuda_device)
    assert launches == 1
    torch.testing.assert_close(y, yp, **TOL["csr"])


def test_csr_kernel_rectangular_with_empty_rows_on_card(cuda_device):
    S = sp.random(3000, 2000, density=0.001, random_state=np.random.RandomState(6))
    A = from_scipy(S, "csr", dtype=torch.float32, device=cuda_device)
    assert (np.diff(S.tocsr().indptr) == 0).any()
    y, yp, _ = _csr_case(A, {}, cuda_device)
    torch.testing.assert_close(y, yp, **TOL["csr"])


@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_f64_kernels_match_plain_on_card(cuda_device, fmt):
    A = gallery.poisson5pt(120, 90, format=fmt, dtype=torch.float64,
                           device=cuda_device)
    y, yp, launches = (_dia_case if fmt == "dia" else _csr_case)(A, {}, cuda_device)
    assert launches == 1 and y.dtype == torch.float64
    torch.testing.assert_close(y, yp, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt,impl", [("dia", "cuda"), ("csr", "cuda"),
                                      ("coo", "cuda"), ("csr", "binned"),
                                      ("coo", "colsort")])
def test_kernel_wrappers_raise_on_card(cuda_device, fmt, impl):
    """A CUDA tensor the kernel cannot take raises; nothing falls back.  The
    CSR kernel takes vectors only; the others take a block (n, k) too."""
    A = gallery.poisson5pt(20, 10, format=fmt, device=cuda_device)
    fn = planned_operator(A, {"impl": impl})
    counters = (dia_spmv, dia_spmm, csr_spmv, binned_spmv, binned_spmm,
                coo_spmv, coo_spmm)
    before = [c.launches for c in counters]
    x = _x(A.num_cols, cuda_device)
    X = torch.stack([x, x], 1)
    with pytest.raises(NotImplementedException):
        fn(X if impl == "cuda" and fmt != "dia" else X[..., None])
    with pytest.raises(InvalidInputException):
        fn(x.double())
    with pytest.raises(InvalidInputException):
        fn(X[:, 0])                                     # not contiguous
    with pytest.raises(InvalidInputException):
        fn(x.cpu())
    if not (impl == "cuda" and fmt != "dia"):
        for bad in (X.T.contiguous().T, X.double(), X.cpu(), X[:-1]):
            with pytest.raises(InvalidInputException):
                fn(bad)
    assert [c.launches for c in counters] == before


def test_cg_kernel_operator_matches_plain_on_card(cuda_device):
    A = gallery.poisson5pt(64, 64, format="csr", device=cuda_device)
    b = torch.as_tensor(np.random.RandomState(0).rand(A.num_rows),
                        dtype=torch.float32, device=cuda_device)
    out = {}
    for dia_impl in ("cuda", "slices"):
        op = planned_operator(A, {"impl": "via_dia", "dia_impl": dia_impl})
        before = dia_spmv.launches
        x, mon = solvers.cg(op, b, monitor=Monitor(b, 2000, 1e-5))
        out[dia_impl] = (x, mon, dia_spmv.launches - before)
    (xk, mk, nk), (xp, mp, np_) = out["cuda"], out["slices"]
    assert mk.converged() and mp.converged()
    assert abs(mk.iteration_count() - mp.iteration_count()) <= 2
    assert nk >= mk.iteration_count() and np_ == 0
    torch.testing.assert_close(xk, xp, rtol=1e-3, atol=1e-3 * float(xp.abs().max()))


def _rails_matrix(seed=2):
    """Row lengths 0 to 4096: empty rows, one 4096-entry row, and lengths
    that are multiples of no group size."""
    rng = np.random.RandomState(seed)
    lengths = np.r_[0, 4096, rng.randint(0, 70, 3000), 0, 33, 5, 1,
                    rng.randint(0, 3, 2000), 1500]
    indptr = np.r_[0, np.cumsum(lengths)]
    n = 6000
    col = np.concatenate([rng.choice(n, k, replace=False) for k in lengths])
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


@pytest.mark.parametrize("block", [128, 512])
@pytest.mark.parametrize("tpr,hub_cap", [(0, 0), (0, 64), (1, 0), (4, 0),
                                         (32, 0), (4, 100)])
def test_binned_kernel_matches_plain_on_card(cuda_device, tpr, hub_cap, block):
    A = from_scipy(_rails_matrix(), "csr", dtype=torch.float32, device=cuda_device)
    fn = build_binned(A, {"threads_per_row": tpr, "hub_cap": hub_cap,
                          "block_size": block})
    a = fn.planned_arrays
    x = _x(A.num_cols, cuda_device)
    before = binned_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    assert binned_spmv.launches - before == 1
    yp = binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"], a["bins"],
                           x, A.num_rows)
    torch.testing.assert_close(y, yp, **TOL["rails"])


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("vpt", [1, 4, 8, 16])
def test_coo_kernel_matches_plain_on_card(cuda_device, vpt, block):
    """vpt 4 cuts the 4096-entry row over 32 chunks of 128 entries; every
    partial of it must reach y through the carry fold."""
    A = from_scipy(_rails_matrix(), "coo", dtype=torch.float32, device=cuda_device)
    fn = build_colsort(A, {"values_per_thread": vpt, "block_size": block})
    a = fn.planned_arrays
    x = _x(A.num_cols, cuda_device)
    before = coo_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    assert coo_spmv.launches - before == 1
    yp = coo_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows)
    torch.testing.assert_close(y, yp, **TOL["rails"])
    torch.testing.assert_close(fn(x), y, rtol=0, atol=0)    # deterministic


@pytest.mark.parametrize("impl", ["binned", "colsort"])
@pytest.mark.parametrize("store", ["bfloat16", "float64"])
def test_rails_other_storage_on_card(cuda_device, impl, store):
    dtype = torch.float64 if store == "float64" else torch.float32
    A = from_scipy(_rails_matrix(4), "csr", dtype=dtype, device=cuda_device)
    cfg = {"impl": impl, "value_dtype": "bfloat16"} if store == "bfloat16" \
        else {"impl": impl}
    y = build_spmv(A, cfg)(_x(A.num_cols, cuda_device, dtype))
    ref = reference_spmv(A, _x(A.num_cols, "cpu", dtype))
    tol = 2e-2 if store == "bfloat16" else 1e-10
    assert np.linalg.norm(y.cpu().numpy() - ref) / np.linalg.norm(ref) < tol


@pytest.mark.parametrize("fmt", ["ell", "ellr", "hyb"])
def test_cuda_impl_of_the_ell_family_on_card(cuda_device, fmt):
    S = _rails_matrix(5) if fmt == "hyb" else \
        gallery.poisson9pt(60, 50, device="cpu").to_scipy()   # ELL's fill guard
    A = from_scipy(S, fmt, dtype=torch.float32, device=cuda_device)
    before = csr_spmv.launches
    y = build_spmv(A, {"impl": "cuda", "block_size": 128})(_x(A.num_cols, cuda_device))
    assert csr_spmv.launches - before == 1
    np.testing.assert_allclose(y.cpu().numpy(),
                               reference_spmv(A, _x(A.num_cols, "cpu")), **TOL["csr"])


@pytest.mark.parametrize("block", [128, 512])
def test_dia_and_csr_block_sizes_on_card(cuda_device, block):
    for fmt, case in (("dia", _dia_case), ("csr", _csr_case)):
        A = gallery.poisson5pt(130, 70, format=fmt, device=cuda_device)
        y, yp, launches = case(A, {"block_size": block}, cuda_device)
        assert launches == 1
        torch.testing.assert_close(y, yp, **TOL[fmt])


# tests/test_torch_spmv_redesign.py's row-length patterns, which the CPU
# walks of the two plans cover at tiles of 256 entries (block 64)
REDESIGN_PATTERNS = {
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
STORES = {"f32": (torch.float32, {}), "bf16": (torch.float32,
                                               {"value_dtype": "bfloat16"}),
          "f64": (torch.float64, {})}


def _pattern_matrix(lengths, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    n = max(1000, int(lengths.max(initial=0)))
    indptr = np.r_[0, np.cumsum(lengths)]
    col = np.concatenate([np.sort(rng.choice(n, k, replace=False)) for k in lengths]
                         + [np.zeros(0, np.int64)])
    S = sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                      shape=(lengths.size, n))
    return from_scipy(S, "csr", dtype=dtype, device=device)


def _store_tol(store):
    return dict(rtol=1e-12, atol=1e-12) if store == "f64" else TOL["csr"]


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("name", list(REDESIGN_PATTERNS))
def test_tiled_csr_kernel_on_patterns_on_card(cuda_device, name, store, block):
    """The nnz-balanced CSR kernel on empty rows, rows across many tiles,
    part and whole tiles, one row and a short wide rectangle: against its
    plain version, every row written (y starts as torch.empty), and two
    calls bitwise equal."""
    dtype, cfg = STORES[store]
    A = _pattern_matrix(REDESIGN_PATTERNS[name], dtype, cuda_device)
    y, yp, launches = _csr_case(A, {**cfg, "block_size": block}, cuda_device)
    assert launches == 1 and y.dtype == dtype
    torch.testing.assert_close(y, yp, **_store_tol(store))
    fn = build_csr(A, {**cfg, "block_size": block})
    x = _x(A.num_cols, cuda_device, dtype)
    assert torch.equal(fn(x), fn(x))


@pytest.mark.parametrize("store", list(STORES))
def test_tiled_csr_short_rows_do_not_depend_on_the_tiling_on_card(cuda_device, store):
    """A band planned by itself (as the mesh path plans it) gives the whole
    matrix's rows bit for bit wherever its rows are short: a short row is
    summed whole, in order, by the tile where it starts."""
    dtype, cfg = STORES[store]
    S = gallery.poisson5pt(300, 200, format="csr", device="cpu").to_scipy()
    x = _x(S.shape[1], cuda_device, dtype)
    whole = build_csr(from_scipy(S, "csr", dtype=dtype, device=cuda_device), cfg)(x)
    for r0 in (1, 7, 2999):
        band = from_scipy(S[r0:], "csr", dtype=dtype, device=cuda_device)
        assert S.indptr[r0] % (256 * ENTRIES_PER_THREAD)   # the tiles fall elsewhere
        assert torch.equal(build_csr(band, cfg)(x), whole[r0:])


@pytest.mark.parametrize("vpt", [1, 3, 4, 16])
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("name", [n for n in REDESIGN_PATTERNS if n != "no entries"])
def test_coo_kernel_on_patterns_on_card(cuda_device, name, store, vpt):
    """The COO chunk kernel writes every row of y itself (no zero fill):
    empty rows in a lane, between lanes and between chunks, before the
    first and after the last entry; against its plain version, and two
    calls bitwise equal."""
    dtype, cfg = STORES[store]
    A = _pattern_matrix(REDESIGN_PATTERNS[name], dtype, cuda_device)
    fn = build_colsort(A, {**cfg, "values_per_thread": vpt})
    a = fn.planned_arrays
    x = _x(A.num_cols, cuda_device, dtype)
    before = coo_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    assert coo_spmv.launches - before == 1 and y.dtype == dtype
    yp = coo_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows)
    torch.testing.assert_close(y, yp, **_store_tol(store))
    assert torch.equal(fn(x), y)


@pytest.mark.parametrize("impl", ["cuda", "colsort"])
def test_redesigned_kernels_after_a_million_empty_rows_on_card(cuda_device, impl):
    """1M rows whose entries all lie in the last 4,096: the CSR plan cuts
    its first tile's rows over many blocks, a tile's worth of rows each,
    and the COO plan zero-fills y (its kernel writes runs of at most
    GAP_ROWS rows); both against the plain version."""
    m, rows = 1_000_000, 4096
    rng = np.random.RandomState(8)
    indptr = np.r_[np.zeros(m - rows + 1, np.int64), 8 * np.arange(1, rows + 1)]
    S = sp.csr_matrix((rng.uniform(-1, 1, 8 * rows), rng.randint(0, m, 8 * rows),
                       indptr), shape=(m, m))
    A = from_scipy(S, "csr", dtype=torch.float32, device=cuda_device)
    fn = build_spmv(A, {"impl": impl})
    if impl == "colsort":
        assert fn.plan_stats["zero_fill"]
    else:
        assert fn.plan_stats["blocks"] > fn.plan_stats["tiles"] + 900
    x = _x(m, cuda_device)
    a = fn.planned_arrays
    y = fn(x)
    yp = csr_spmv_plain(a["row"], a["col"], a["val"], x, m)
    torch.testing.assert_close(y, yp, **TOL["csr"])
    assert not y[:m - rows].any()


@pytest.mark.parametrize("impl", ["cuda", "colsort"])
def test_redesigned_plans_allocate_only_y_and_capture_on_card(cuda_device, impl):
    """A call of either plan launches its two kernels (no fill), allocates
    y and nothing else, and is captured whole by the harness's CUDA graph
    (no host sync)."""
    from torch.profiler import ProfilerActivity, profile
    from cusp_autotuned_tpu_torch.benchmarks import harness
    A = from_scipy(_rails_matrix(7), "csr", dtype=torch.float32, device=cuda_device)
    fn = build_spmv(A, {"impl": impl})
    x = _x(A.num_cols, cuda_device)
    fn(x)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"]
    y = fn(x)
    assert torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"] \
        == allocs + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(kernels) == 2, [e.name for e in kernels]
    assert harness.graph_time_s(fn, x) > 0
    assert torch.equal(fn(x), y)


def test_stream_triad_on_card(cuda_device):
    x = _x(1_000_003, cuda_device)
    y = _x(1_000_003, cuda_device, seed=4)
    want = calibrate.stream_triad_plain(x.cpu(), y.cpu())
    before = calibrate.stream_triad.launches
    calibrate.stream_triad(x, y)
    assert calibrate.stream_triad.launches - before == 1
    torch.testing.assert_close(y.cpu(), want, rtol=0, atol=0)
    gbps = calibrate.stream_gbps(cuda_device, nbytes=256 << 20, reps=5)
    assert np.isfinite(gbps) and gbps > 0


def test_small_walk_on_card(cuda_device):
    """Every configuration of a small walk on the card is Ok or a refused
    conversion (every plan takes a 1-D x here, so CompilationFailed would
    be a fault), with a positive device time, and the kernels'
    configurations validate."""
    A = from_scipy(_rails_matrix(6), "csr", dtype=torch.float32, device=cuda_device)
    x = _x(A.num_cols, cuda_device)
    results = Tuner(warmup=1, repeats=2).tune(A, x, reference_computation=reference_spmv)
    for r in results:
        assert r.status in (ResultStatus.Ok, ResultStatus.DeviceLimitsExceeded), \
            f"{r.configuration}: {r.status} {r.error}"
        assert not r.is_valid() or 0 < r.duration_ms < 1e3
    ok = {r.configuration["impl"] for r in results if r.is_valid()}
    assert {"cuda", "binned", "colsort", "colsort2", "routed", "segsum"} <= ok


def test_tuner_times_the_device_not_the_host(cuda_device):
    """The card's channel replays the calls from a CUDA graph, so a call's
    host work (here 2 ms of sleep around the kernel) is not in its time."""
    A = gallery.poisson5pt(64, 64, format="dia", device=cuda_device)
    fn = build_dia(A, {})
    x = _x(A.num_cols, cuda_device)

    def slow_host(x):
        time.sleep(0.002)
        return fn(x)

    ms = Tuner(warmup=1, repeats=4)._time(slow_host, x)
    assert 0 < ms < 0.5


def _block(n, k, device, dtype=torch.float32, seed=3):
    X = np.random.RandomState(seed).randn(n, k)
    return torch.as_tensor(X, dtype=dtype, device=device)


@pytest.mark.parametrize("k", [1, 3, 16, 33, 128])
@pytest.mark.parametrize("value_dtype", ["none", "bfloat16"])
def test_dia_spmm_kernel_matches_plain_on_card(cuda_device, value_dtype, k):
    A = gallery.poisson5pt(300, 200, format="dia", device=cuda_device)
    fn = build_dia(A, {"value_dtype": value_dtype, "block_size": 128})
    X = _block(A.num_cols, k, cuda_device)
    before = dia_spmm.launches
    Y = fn(X)
    torch.cuda.synchronize()
    assert dia_spmm.launches - before == 1 and Y.shape == (A.num_rows, k)
    Yp = dia_spmv_plain(fn.planned_arrays["data"], A.offsets, X, A.shape)
    torch.testing.assert_close(Y, Yp, **TOL["dia"])


@pytest.mark.parametrize("shape,offsets", [((300, 520), [0, 150, 320]),
                                           ((8, 300), [0, 1]),
                                           ((520, 300), [-220, 0])])
def test_dia_spmm_rectangular_on_card(cuda_device, shape, offsets):
    rng = np.random.RandomState(19)
    S = sp.diags([rng.uniform(0.5, 2.0, shape[0]) for _ in offsets], offsets,
                 shape=shape)
    A = from_scipy(S, "dia", dtype=torch.float32, device=cuda_device)
    X = _block(shape[1], 16, cuda_device)
    Y = build_dia(A, {})(X)
    np.testing.assert_allclose(Y.cpu().numpy(), S @ X.cpu().double().numpy(),
                               **TOL["rails"])


@pytest.mark.parametrize("k", [1, 3, 16, 40])
@pytest.mark.parametrize("tpr,hub_cap,block", [(0, 0, 256), (0, 64, 128),
                                               (4, 100, 512), (0, 1, 256)])
def test_binned_spmm_kernel_matches_plain_on_card(cuda_device, tpr, hub_cap,
                                                  block, k):
    """hub_cap 1 makes every row of two or more entries a hub row."""
    A = from_scipy(_rails_matrix(), "csr", dtype=torch.float32, device=cuda_device)
    fn = build_binned(A, {"threads_per_row": tpr, "hub_cap": hub_cap,
                          "block_size": block})
    a = fn.planned_arrays
    X = _block(A.num_cols, k, cuda_device)
    before = binned_spmm.launches
    Y = fn(X)
    torch.cuda.synchronize()
    assert binned_spmm.launches - before == 1
    Yp = binned_spmv_plain(a["indptr"], a["col"], a["val"], a["perm"], a["bins"],
                           X, A.num_rows)
    torch.testing.assert_close(Y, Yp, **TOL["rails"])
    torch.testing.assert_close(fn(X), Y, rtol=0, atol=0)    # deterministic


@pytest.mark.parametrize("k", [1, 3, 16, 40])
@pytest.mark.parametrize("vpt,block", [(1, 128), (4, 256), (16, 512)])
def test_coo_spmm_kernel_matches_plain_on_card(cuda_device, vpt, block, k):
    """The 4096-entry row spans many chunks; every partial of every column
    reaches Y through the carry fold, and reruns are bitwise equal."""
    A = from_scipy(_rails_matrix(), "coo", dtype=torch.float32, device=cuda_device)
    fn = build_colsort(A, {"values_per_thread": vpt, "block_size": block})
    a = fn.planned_arrays
    X = _block(A.num_cols, k, cuda_device)
    before = coo_spmm.launches
    Y = fn(X)
    torch.cuda.synchronize()
    assert coo_spmm.launches - before == 1
    Yp = coo_spmv_plain(a["row"], a["col"], a["val"], X, A.num_rows)
    torch.testing.assert_close(Y, Yp, **TOL["rails"])
    for _ in range(3):
        torch.testing.assert_close(fn(X), Y, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["via_dia", "binned", "colsort"])
@pytest.mark.parametrize("store", ["bfloat16", "float64"])
def test_spmm_other_storage_on_card(cuda_device, impl, store):
    """via_dia runs the DIA SpMM kernel on a banded matrix."""
    dtype = torch.float64 if store == "float64" else torch.float32
    S = _rails_matrix(4) if impl != "via_dia" else sp.diags(
        [np.ones(900), 2 * np.ones(1000), 3 * np.ones(900)], [-100, 0, 100])
    A = from_scipy(S, "csr", dtype=dtype, device=cuda_device)
    cfg = {"impl": impl}
    if store == "bfloat16":
        cfg["value_dtype"] = "bfloat16"
    X = _block(A.num_cols, 5, cuda_device, dtype)
    before = [c.launches for c in (dia_spmm, binned_spmm, coo_spmm)]
    Y = build_spmv(A, cfg)(X)
    assert Y.dtype == dtype
    assert sum(c.launches for c in (dia_spmm, binned_spmm, coo_spmm)) == \
        sum(before) + 1
    ref = reference_spmv(A, X)
    tol = 2e-2 if store == "bfloat16" else 1e-10
    assert np.linalg.norm(Y.cpu().numpy() - ref) / np.linalg.norm(ref) < tol


def test_block_defaults_and_walk_on_card(cuda_device):
    """A 2-D x defaults to the DIA SpMM kernel for dia and to binned
    otherwise; a walk at k = 8 validates every SpMM kernel, and the CSR
    kernel (vectors only) is the one skippable result."""
    A = from_scipy(_rails_matrix(6), "csr", dtype=torch.float32, device=cuda_device)
    X = _block(A.num_cols, 8, cuda_device)
    assert default_config(A, X)["impl"] == "binned"
    D = gallery.poisson5pt(30, 30, format="dia", device=cuda_device)
    assert default_config(D, X)["impl"] == "cuda"
    before = [c.launches for c in (binned_spmm, coo_spmm)]
    results = Tuner(warmup=1, repeats=2).tune(A, X, reference_computation=reference_spmv)
    for r in results:
        ok = (ResultStatus.Ok, ResultStatus.DeviceLimitsExceeded)
        if r.configuration["impl"] == "cuda":
            ok = (ResultStatus.CompilationFailed,)
        assert r.status in ok, f"{r.configuration}: {r.status} {r.error}"
    valid = {r.configuration["impl"] for r in results if r.is_valid()}
    assert {"binned", "colsort", "colsort2", "routed", "segsum"} <= valid
    assert binned_spmm.launches > before[0] and coo_spmm.launches > before[1]


def test_lobpcg_kernel_operator_matches_plain_on_card(cuda_device):
    A = gallery.poisson5pt(40, 40, format="csr", device=cuda_device)
    out = {}
    for impl in ("binned", "segsum"):
        op = planned_operator(A, {"impl": impl})
        before = binned_spmm.launches
        lam, _, its = eigen.lobpcg(op, maxiter=200, tol=1e-5,
                                   return_iterations=True)
        out[impl] = (float(lam), its, binned_spmm.launches - before)
    exact = 4 + 4 * np.cos(np.pi / 41)
    (lk, ik, nk), (lp, ip, np_) = out["binned"], out["segsum"]
    assert abs(lk - exact) / exact < 1e-4 and abs(lp - exact) / exact < 1e-4
    assert nk >= ik and np_ == 0


# -- the colsort2 and routed rails ---------------------------------------------

@functools.cache
def _scattered_with_band_host(seed=7):
    rng = np.random.RandomState(seed)
    m, n = 20000, 50000
    rows = np.repeat(np.arange(m), 8)
    S = (sp.coo_matrix((rng.uniform(-1, 1, rows.size),
                        (rows, rng.randint(0, n, rows.size))), shape=(m, n))
         + sp.diags([rng.uniform(-1, 1, m) for _ in range(41)],
                    list(range(-20, 21)), shape=(m, n))).tocsr()
    col, val = S.indices.copy(), S.data.copy()
    for r in range(0, m, 7):                   # unsort some rows' columns
        lo, hi = S.indptr[r], S.indptr[r + 1]
        perm = lo + rng.permutation(hi - lo)
        col[lo:hi], val[lo:hi] = col[perm], val[perm]
    return S.indptr, col, val, (m, n)


def _scattered_with_band():
    """20000 x 50000: 8 scattered entries a row plus a band of 41 entries a
    row, whose SpMM windows a routed row block stages; the columns of every
    seventh row unsorted."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    indptr, col, val, shape = _scattered_with_band_host()
    return csr_matrix(indptr, col, val, shape, dtype=torch.float32, device="cuda")


def _rail_case(fn, plain, x, counters):
    before = [c.launches for c in counters]
    y = fn(x)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    torch.testing.assert_close(y, plain(x), **TOL["rails"])
    for _ in range(2):
        torch.testing.assert_close(fn(x), y, rtol=0, atol=0)    # deterministic
    return launched


@pytest.mark.parametrize("K,V,hub_cap,block", [(1, 8, 0, 256), (2, 32, 0, 256),
                                               (4, 8, 64, 512), (4, 32, 0, 128),
                                               (8, 8, 0, 256), (2, 0, 1, 256)])
def test_colsort2_kernel_matches_plain_on_card(cuda_device, K, V, hub_cap, block):
    """hub_cap 1 makes every row of two or more entries a hub row; the
    4096-entry row spans 32 hub virtual rows."""
    A = from_scipy(_rails_matrix(), "csr", dtype=torch.float32, device=cuda_device)
    fn = build_colsort2(A, {"vrow_planes": K, "vrow_len": V, "hub_cap": hub_cap,
                            "block_size": block})
    a, st = fn.planned_arrays, fn.plan_stats
    assert st["hub_rows"] > 0
    launched = _rail_case(
        fn, lambda x: colsort2_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                          x, A.num_rows, K, st["vrow_len"], st["thr"]),
        _x(A.num_cols, cuda_device), (colsort2_spmv, colsort2_hub))
    assert launched == [1, 1]


@pytest.mark.parametrize("k", [1, 3, 16, 40])
@pytest.mark.parametrize("K,V,hub_cap,block", [(1, 8, 0, 256), (4, 32, 64, 512),
                                               (2, 0, 1, 256)])
def test_colsort2_spmm_kernel_matches_plain_on_card(cuda_device, K, V, hub_cap,
                                                    block, k):
    A = from_scipy(_rails_matrix(), "csr", dtype=torch.float32, device=cuda_device)
    fn = build_colsort2(A, {"vrow_planes": K, "vrow_len": V, "hub_cap": hub_cap,
                            "block_size": block})
    a, st = fn.planned_arrays, fn.plan_stats
    launched = _rail_case(
        fn, lambda X: colsort2_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                          X, A.num_rows, K, st["vrow_len"], st["thr"]),
        _block(A.num_cols, k, cuda_device), (colsort2_spmm, colsort2_hub_spmm))
    assert launched == [1, 1]


@pytest.mark.parametrize("window", [4096, 8192, 16384])
@pytest.mark.parametrize("block", [256, 512])
@pytest.mark.parametrize("matrix", ["rails", "scattered"])
def test_routed_kernel_matches_plain_on_card(cuda_device, matrix, block, window):
    """The rails matrix has a tail (its 4096- and 1500-entry rows); the
    scattered one's rows of ~49 entries (8 scattered and a band of 41),
    some unsorted, take a warp each."""
    A = (from_scipy(_rails_matrix(), "csr", dtype=torch.float32, device=cuda_device)
         if matrix == "rails" else _scattered_with_band())
    fn = build_routed(A, {"window": window, "block_size": block})
    a, st = fn.planned_arrays, fn.plan_stats
    assert (st["tail"] > 0) == (matrix == "rails")
    assert st["long_rows"] > 0
    launched = _rail_case(
        fn, lambda x: routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                        x, A.num_rows, st["hub_cap"]),
        _x(A.num_cols, cuda_device), (routed_spmv, colsort2_hub))
    assert launched == [1, int(matrix == "rails")]


@pytest.mark.parametrize("k", [1, 3, 16, 40])
@pytest.mark.parametrize("window,block", [(4096, 256), (16384, 512)])
@pytest.mark.parametrize("matrix", ["rails", "scattered"])
def test_routed_spmm_kernel_matches_plain_on_card(cuda_device, matrix, window,
                                                  block, k):
    A = (from_scipy(_rails_matrix(), "csr", dtype=torch.float32, device=cuda_device)
         if matrix == "rails" else _scattered_with_band())
    fn = build_routed(A, {"window": window, "block_size": block})
    a, st = fn.planned_arrays, fn.plan_stats
    assert st["staged_spmm_windows"] > 0
    launched = _rail_case(
        fn, lambda X: routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                        X, A.num_rows, st["hub_cap"]),
        _block(A.num_cols, k, cuda_device), (routed_spmm, colsort2_hub_spmm))
    assert launched == [1, int(matrix == "rails")]


def _edge_rows(lengths, n, seed, tail_cols=0):
    """A seeded CSR matrix of the given row lengths (columns without repeats
    in a row; with tail_cols, drawn from x's last tail_cols columns)."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int64)
    lo = n - tail_cols if tail_cols else 0
    col = np.concatenate([np.sort(rng.choice(np.arange(lo, n), k, replace=False))
                          for k in lengths] + [np.zeros(0, np.int64)])
    indptr = np.r_[0, np.cumsum(lengths)]
    return sp.csr_matrix((rng.uniform(-1, 1, indptr[-1]), col, indptr),
                         shape=(lengths.size, n))


def _rail_plain(impl, fn, A):
    a, st = fn.planned_arrays, fn.plan_stats
    if impl == "colsort2":
        return lambda x: colsort2_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"],
                                             x, A.num_rows, st["vrow_planes"],
                                             st["vrow_len"], st["thr"])
    return lambda x: routed_spmv_plain(a["indptr"], a["col"], a["val"], a["hub"], x,
                                       A.num_rows, st["hub_cap"])


@functools.cache
def _edges_host():
    """The row walk's edges (csrc/rail_rows.cuh): rows of 16/17, 32/33 and
    64/65 entries (short or long, main or hub at thr 16 and 64), runs of
    40 to 1000 empty rows, LP's shape (a warp a row) and rows that read x's
    last columns."""
    edges = _edge_rows([0] * 40 + [16, 17, 32, 33, 64, 65, 5, 0] * 300 + [0] * 1000
                       + [3] * 50 + [0] * 70, 7000, 31)
    lp = _edge_rows(np.random.RandomState(4).randint(1200, 1400, 2000), 9000, 32)
    tail = _edge_rows([16] * 2048, 4998, 33, tail_cols=300)
    return {"edges": edges, "lp": lp, "tail": tail}


@pytest.mark.parametrize("impl,matrix,cfg", [
    ("colsort2", "edges", {"vrow_planes": 2, "vrow_len": 8}),
    ("colsort2", "edges", {"vrow_planes": 2, "vrow_len": 32, "hub_cap": 64}),
    ("colsort2", "edges", {"vrow_planes": 4, "vrow_len": 0, "hub_cap": 64,
                           "block_size": 512}),
    ("colsort2", "lp", {}),
    ("routed", "edges", {"hub_cap": 64, "window": 4096}),
    ("routed", "edges", {"hub_cap": 64, "block_size": 512}),
    ("routed", "lp", {}),
    ("routed", "tail", {"window": 4096}),
])
def test_rail_row_walk_edges_match_plain_on_card(cuda_device, impl, matrix, cfg):
    """Every edge of the shared row walk against the plain version, two calls
    equal bit for bit; on LP's shape every row takes a warp."""
    A = from_scipy(_edges_host()[matrix], "csr", dtype=torch.float32,
                   device=cuda_device)
    fn = (build_colsort2 if impl == "colsort2" else build_routed)(A, cfg)
    st = fn.plan_stats
    if matrix == "lp":
        assert st["long_rows"] == A.num_rows
    counter = colsort2_spmv if impl == "colsort2" else routed_spmv
    launched = _rail_case(fn, _rail_plain(impl, fn, A), _x(A.num_cols, cuda_device),
                          (counter,))
    assert launched == [1]


@pytest.mark.parametrize("window", [4096, 8192])
def test_routed_spmv_is_the_same_walk_at_every_window_on_card(cuda_device, window):
    """The SpMV reads every x through L1/L2: a plan of any window gives the
    default plan's y bit for bit."""
    A = from_scipy(_edges_host()["edges"], "csr", dtype=torch.float32,
                   device=cuda_device)
    x = _x(A.num_cols, cuda_device)
    y = build_routed(A, {"hub_cap": 64, "window": window})(x)
    assert torch.equal(y, build_routed(A, {"hub_cap": 64})(x))


@pytest.mark.parametrize("impl", ["colsort2", "routed"])
def test_rail_row_walk_of_a_band_is_the_whole_walk_on_card(cuda_device, impl):
    """Rows 300..2599 planned alone (as shard_planned_blocks plans a band,
    the whole matrix's hub_cap) give the whole plan's y on those rows bit
    for bit: each row's sum is taken in an order fixed by the row."""
    S = _edges_host()["edges"]
    cfg = {"vrow_planes": 2, "vrow_len": 32, "hub_cap": 64} if impl == "colsort2" \
        else {"hub_cap": 64, "window": 4096}
    build = build_colsort2 if impl == "colsort2" else build_routed
    x = _x(S.shape[1], cuda_device)
    whole = build(from_scipy(S, "csr", dtype=torch.float32, device=cuda_device), cfg)(x)
    band = build(from_scipy(S[300:2600], "csr", dtype=torch.float32,
                            device=cuda_device), cfg)(x)
    assert torch.equal(band, whole[300:2600])


@pytest.mark.parametrize("impl", ["colsort2", "routed"])
@pytest.mark.parametrize("store", ["bfloat16", "float64"])
@pytest.mark.parametrize("k", [0, 5])
def test_new_rails_other_storage_on_card(cuda_device, impl, store, k):
    dtype = torch.float64 if store == "float64" else torch.float32
    A = from_scipy(_rails_matrix(4), "csr", dtype=dtype, device=cuda_device)
    cfg = {"impl": impl, "block_size": 256}
    if store == "bfloat16":
        cfg["value_dtype"] = "bfloat16"
    x = _x(A.num_cols, cuda_device, dtype) if k == 0 else \
        _block(A.num_cols, k, cuda_device, dtype)
    y = build_spmv(A, cfg)(x)
    assert y.dtype == dtype
    ref = reference_spmv(A, x)
    tol = 2e-2 if store == "bfloat16" else 1e-10
    assert np.linalg.norm(y.cpu().numpy() - ref) / np.linalg.norm(ref) < tol


@pytest.mark.parametrize("impl", ["colsort2", "routed"])
def test_new_rail_wrappers_raise_on_card(cuda_device, impl):
    A = gallery.poisson5pt(20, 10, format="csr", device=cuda_device)
    fn = planned_operator(A, {"impl": impl, "block_size": 256})
    counters = (colsort2_spmv, colsort2_spmm, colsort2_hub, colsort2_hub_spmm,
                routed_spmv, routed_spmm)
    before = [c.launches for c in counters]
    x = _x(A.num_cols, cuda_device)
    X = torch.stack([x, x], 1)
    with pytest.raises(NotImplementedException):
        fn(X[..., None])
    for bad in (x.double(), X[:, 0], x.cpu(), X.T.contiguous().T, X.double(),
                X.cpu(), X[:-1]):
        with pytest.raises(InvalidInputException):
            fn(bad)
    assert [c.launches for c in counters] == before
    with pytest.raises(FormatConversionException):
        build_spmv(from_scipy(sp.coo_matrix((6, 7)), "csr", dtype=torch.float32,
                              device=cuda_device), {"impl": impl})


@pytest.mark.parametrize("from_shared", [True, False])
@pytest.mark.parametrize("passes", [2, 3, 18])
def test_take_probe_matches_plain_on_card(cuda_device, from_shared, passes):
    """Both instantiations of the take probe compute the plain version's
    function; products and sums are rounded one by one in pass order, so
    the bar is rtol 1e-6 (the JAX package's, tests/test_calibrate.py)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64 * 128, 128).astype(np.float32))
    idx = calibrate.take_probe_planes()
    want = calibrate.take_probe_plain(x, idx, passes)
    before = calibrate.take_probe.launches
    got = calibrate.take_probe(x.to(cuda_device), idx.to(cuda_device), passes,
                               from_shared)
    torch.cuda.synchronize()
    assert calibrate.take_probe.launches - before == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def test_take_probe_raises_on_card(cuda_device):
    x = torch.zeros(2 * 128, 128, device=cuda_device)
    idx = calibrate.take_probe_planes().to(cuda_device)
    before = calibrate.take_probe.launches
    for args in ((x.double(), idx, 2), (x, idx.long(), 2), (x[:100], idx, 2),
                 (x, idx, 19), (x, idx.cpu(), 2)):
        with pytest.raises(InvalidInputException):
            calibrate.take_probe(*args)
    assert calibrate.take_probe.launches == before
    ns = calibrate.tile_take_ns(cuda_device, tiles=256, reps=3)
    assert np.isfinite(ns) and ns > 0


def test_smoothed_aggregation_plans_on_card(cuda_device):
    """smoothed_aggregation(spmv_config={}) plans every level on the card
    (no CPU tensor in any operator; a 2-D stencil's fine A on the DIA
    kernel), and its
    V-cycle equals the V-cycle through the containers' plain products to
    rtol 1e-5 (f32 sums in another order)."""
    from cusp_autotuned_tpu_torch.precond import smoothed_aggregation
    from cusp_autotuned_tpu_torch.precond.multilevel import Multilevel

    def tensors(op):
        """Every tensor an operator holds, but the binned plan's `bins`: a
        small host table of launch parameters (binned_spmv's), by design."""
        if isinstance(op, torch.Tensor):
            yield op
        elif isinstance(op, (tuple, list)):
            for v in op:
                yield from tensors(v)
        elif isinstance(op, dict):
            for k, v in op.items():
                if k != "bins":
                    yield from tensors(v)
        elif hasattr(op, "__dataclass_fields__"):
            for name in op.__dataclass_fields__:
                yield from tensors(getattr(op, name))

    for A in (gallery.poisson5pt(300, 300, format="csr", device=cuda_device),
              gallery.poisson7pt(20, 20, 20, format="csr", device=cuda_device)):
        M = smoothed_aggregation(A, spmv_config={})
        if A.num_rows == 300 * 300:
            assert M.levels[0].Aop.impl == "via_dia"
        for lvl in M.levels:
            for op in (lvl.Aop, lvl.Rop, lvl.Pop):
                assert op is not None
                assert all(t.device.type == "cuda" for t in tensors(op))
        plain = Multilevel(levels=tuple(
            type(lvl)(R=lvl.R, A=lvl.A, P=lvl.P, smoother=lvl.smoother)
            for lvl in M.levels), coarse=M.coarse, shape=M.shape)
        b = _x(A.num_rows, cuda_device)
        torch.testing.assert_close(M(b), plain(b), rtol=1e-5, atol=1e-5)
        x, mon = solvers.cg(A, b, M=M, monitor=Monitor(b, 200, 1e-5))
        assert mon.converged() and mon.iteration_count() < 40


# -- the multi-device path on one card: the DIA band kernels and sharded plans

@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("dtype,store", [(torch.float32, None),
                                         (torch.float32, torch.bfloat16),
                                         (torch.float64, None)])
def test_dia_band_kernels_match_plain_on_card(cuda_device, dtype, store, k):
    """Every band of a banded via_dia plan against the band's plain version
    (rtol 1e-6: the same products added in the same order) and against the
    unsharded DIA kernel's rows."""
    from cusp_autotuned_tpu_torch.kernels.dia import (
        _pad_rows, dia_band_spmm, dia_band_spmv, dia_band_spmv_plain)
    from cusp_autotuned_tpu_torch.parallel.sharded_plans import dia_bands
    S = sp.diags([np.random.RandomState(d).uniform(0.5, 2.0, 3000) for d in range(5)],
                 [-301, -1, 0, 2, 640], shape=(3000, 3000))
    D = from_scipy(S, "dia", dtype=dtype, device=cuda_device)
    data, band, left, x_rows = dia_bands(D, 4)
    data = data.to(store or dtype)
    offsets = torch.tensor(D.offsets, dtype=torch.int32, device=cuda_device)
    x = torch.as_tensor(np.random.RandomState(5).randn(3000, k), dtype=dtype,
                        device=cuda_device)
    x = x[:, 0].contiguous() if k == 1 else x
    x_pad = _pad_rows(x, left, x_rows - left - 3000)
    reach = (min(D.offsets), max(D.offsets))
    whole = dia_spmv(data[:, :3000].contiguous(), offsets, x, D.shape) if k == 1 \
        else dia_spmm(data[:, :3000].contiguous(), offsets, x, D.shape)
    wrapper = dia_band_spmv if k == 1 else dia_band_spmm
    for i in range(4):
        before = wrapper.launches
        y = wrapper(data[:, i * band:(i + 1) * band], offsets, x_pad, left,
                    i * band, reach)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        yp = dia_band_spmv_plain(data[:, i * band:(i + 1) * band], D.offsets,
                                 x_pad, left, i * band)
        torch.testing.assert_close(y, yp, rtol=1e-6, atol=1e-6)
        rows = whole[i * band:(i + 1) * band]
        torch.testing.assert_close(y[:rows.shape[0]], rows, rtol=1e-6, atol=1e-6)
    with pytest.raises(InvalidInputException):
        wrapper(data[:, :band], offsets, x_pad[:-1], left, 3 * band, reach)


def test_sharded_operators_keep_vectors_on_card(cuda_device):
    """A mesh of four entries on one card: the banded DIA plan, a
    block-partitioned plan and a row-sharded CSR take x on the card and
    return y there, through their kernels, and match the oracle."""
    from cusp_autotuned_tpu_torch import parallel
    from cusp_autotuned_tpu_torch.kernels.dia import dia_band_spmv
    from cusp_autotuned_tpu_torch.ops.convert import convert
    mesh = parallel.make_row_mesh([cuda_device] * 4)
    A = gallery.poisson5pt(60, 70, format="csr", device=cuda_device)
    x = _x(A.num_cols, cuda_device)
    want = reference_spmv(A, x)
    before = (dia_band_spmv.launches, binned_spmv.launches, csr_spmv.launches)
    ops = (parallel.shard_planned_dia(convert(A, "dia"), mesh),
           parallel.shard_planned_blocks(A, mesh, {"impl": "binned"}),
           parallel.shard_rows(A, mesh))
    for op in ops:
        y = op(x)
        assert y.device.type == "cuda" and y.shape == (A.num_rows,)
        np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    after = (dia_band_spmv.launches, binned_spmv.launches, csr_spmv.launches)
    assert all(a - b >= 4 for a, b in zip(after, before))
    b = _x(A.num_rows, cuda_device, seed=8)
    x_cg, mon = solvers.cg(A, b, monitor=Monitor(b, 500, 1e-5), mesh=mesh)
    assert mon.converged() and x_cg.device.type == "cuda"


@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_kernels_refuse_complex_at_build_time_on_card(cuda_device, fmt):
    S = (sp.random(40, 40, density=0.1, random_state=np.random.RandomState(2))
         + sp.eye(40)).astype(np.complex64)
    A = from_scipy(S, fmt, device=cuda_device)
    with pytest.raises(NotImplementedException):
        build_spmv(A, {"impl": "cuda"})
    assert default_config(A)["impl"] != "cuda"
    y = planned_operator(A)(torch.ones(40, dtype=torch.complex64, device=cuda_device))
    np.testing.assert_allclose(y.cpu().numpy(), S @ np.ones(40), rtol=1e-5)


# -- the measurement path: the launch floor and the three probes ---------------

def test_launch_floor_matches_plain_bit_for_bit_on_card(cuda_device):
    from cusp_autotuned_tpu_torch.benchmarks import harness
    x = harness.floor_tile(cuda_device)
    before = harness.launch_floor.launches
    y = harness.launch_floor(x)
    assert harness.launch_floor.launches == before + 1
    assert torch.equal(y, harness.launch_floor_plain(x))
    floor = harness.launch_floor_s(cuda_device, samples=3, per_sample=10)
    assert 0 < floor["graph_s"] <= floor["per_call_s"]
    with pytest.raises(InvalidInputException):
        harness.launch_floor(torch.zeros(2048, device=cuda_device))


@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("mode", ["full", "noshift", "nodata", "nobounds"])
def test_dia_probe_matches_plain_on_card(cuda_device, mode, block):
    from cusp_autotuned_tpu_torch.benchmarks import dia_probe
    A = gallery.poisson5pt(150, 170, format="dia", device=cuda_device)
    x = _x(A.num_cols, cuda_device)
    fn = dia_probe.build_probe(A, block, mode)
    xin = fn.prepare(x)
    before = dia_probe.dia_probe.launches
    y = fn(xin)
    assert dia_probe.dia_probe.launches == before + 1
    plain = dia_probe.dia_probe_plain(A.data, A.offsets, xin, A.shape, mode,
                                      -min(A.offsets))
    np.testing.assert_allclose(y.cpu().numpy(), plain.cpu().numpy(), **TOL["dia"])
    if mode in ("full", "nobounds"):
        assert torch.equal(y, build_dia(A, {})(x))


@pytest.mark.parametrize("k", [3, 16, 128])
@pytest.mark.parametrize("mode", ["shipped", "team=32", "team=64", "team=128",
                                  "xtile", "nodata"])
def test_dia_spmm_probe_matches_plain_on_card(cuda_device, mode, k):
    from cusp_autotuned_tpu_torch.benchmarks import dia_spmm_probe
    A = gallery.poisson5pt(60, 70, format="dia", device=cuda_device)
    X = torch.from_numpy(np.random.RandomState(2).randn(A.num_cols, k)
                         .astype(np.float32)).to(cuda_device)
    for block in (256, 1024):
        Y = dia_spmm_probe.build_probe(A, mode, block)(X)
        plain = dia_spmm_probe.dia_spmm_probe_plain(A.data, A.offsets, X, A.shape,
                                                    mode)
        np.testing.assert_allclose(Y.cpu().numpy(), plain.cpu().numpy(),
                                   **TOL["dia"])
        if mode != "nodata":
            assert torch.equal(Y, build_dia(A, {})(X))


def _routed_probe_matrix(device):
    """Rows of four entries near column 4 r, two anywhere, and one hub row
    of 300 entries."""
    rng = np.random.RandomState(5)
    m, n = 8192, 40000
    rows = np.repeat(np.arange(m), 6)
    local = (4 * rows + np.tile([0, 1, 2, 3, 0, 0], m)) % n
    cols = np.where(np.tile([1, 1, 1, 1, 0, 0], m).astype(bool), local,
                    rng.randint(0, n, rows.size))
    rows = np.r_[rows, np.full(300, 11)]
    cols = np.r_[cols, rng.choice(n, 300, replace=False)]
    S = sp.coo_matrix((rng.uniform(-1, 1, rows.size), (rows, cols)), shape=(m, n))
    return from_scipy(S.tocsr(), "csr", dtype=torch.float32, device=device)


@pytest.mark.parametrize("mode", ["full", "nohub", "loads"])
def test_routed_probe_matches_plain_on_card(cuda_device, mode):
    from cusp_autotuned_tpu_torch.benchmarks import routed_probe
    A = _routed_probe_matrix(cuda_device)
    x = _x(A.num_cols, cuda_device)
    config = {"hub_cap": 32, "window": 4096, "block_size": 256}
    fn, info = routed_probe.build_probe(A, config, mode)
    assert info["tail_share"] > 0
    before = routed_probe.routed_probe.launches
    y = fn(x)
    assert routed_probe.routed_probe.launches == before + 1
    args = (A.shape, info["hub_cap"], mode)
    a = fn.planned_arrays
    plain = routed_probe.routed_probe_plain(a, x, *args)
    scale = routed_probe.routed_probe_plain({**a, "val": a["val"].abs()}, x.abs(),
                                            *args)
    assert bool(((y - plain).abs() <= 1e-4 + 1e-4 * scale).all())
    if mode == "full":
        assert torch.equal(y, build_routed(A, config)(x))
