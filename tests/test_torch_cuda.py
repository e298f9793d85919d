"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA device.
The module imports neither JAX nor the JAX package, so that it also runs on
a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets up JAX.)  The tolerances are
the reference's own for its DIA, CSR and lane-binned kernels
(tests/test_pallas.py:22, :97 and :161)."""

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
from cusp_autotuned_tpu_torch.kernels.csr import build_csr, csr_spmv, csr_spmv_plain
from cusp_autotuned_tpu_torch.kernels.dia import (
    build_dia, dia_spmm, dia_spmv, dia_spmv_plain,
)
from cusp_autotuned_tpu_torch.operators import planned_operator
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
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
    assert {"cuda", "binned", "colsort", "segsum"} <= ok


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
    assert {"binned", "colsort", "segsum"} <= valid
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
