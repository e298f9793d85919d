"""The probes' plain versions on the CPU.

Each probe's shipped mode (dia_probe `full`, dia_spmm_probe `shipped`,
routed_probe `full`) is held against the JAX package's shipped kernel run
as the JAX tests run it on the CPU: build_dia in interpret mode
(tests/test_pallas.py:19, :68; the JAX DIA SpMM through the same build
function at k = 3, 16 and 128) and pallas_routed.build_routed in
interpret mode (as
tests/test_torch_routed.py does), at that file's tolerances (DIA rtol 1e-5,
atol 1e-4, :22; rails 1e-4, :161).  Every other mode is held against a
numpy transcription of its definition.  The CUDA kernels are held against
these plain versions, and their shipped modes against the shipped kernels
bit for bit, on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_dia import build_dia as jax_dia
from cusp_autotuned_tpu.kernels.pallas_routed import build_routed as jax_routed

from cusp_autotuned_tpu_torch.benchmarks import dia_probe, dia_spmm_probe, routed_probe
from cusp_autotuned_tpu_torch.kernels.routed import build_routed
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

from tests.torch_parity import one_thread, port_of  # noqa: F401

DIA_TOL = dict(rtol=1e-5, atol=1e-4)      # tests/test_pallas.py:22
RAIL_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_pallas.py:161


def _dense_dia(A):
    """A port DIA matrix as a dense numpy array (f64)."""
    m, n = A.shape
    D = np.zeros((m, n))
    data = A.data.double().numpy()
    for d, off in enumerate(A.offsets):
        for i in range(m):
            if 0 <= i + off < n:
                D[i, i + off] = data[d, i]
    return D


# -- the DIA probe --------------------------------------------------------------

@functools.cache
def _dia_case():
    J = jgallery.poisson5pt(37, 41, format="dia", dtype=np.float32)
    x = np.random.RandomState(3).randn(J.num_cols).astype(np.float32)
    y = np.asarray(jax.jit(jax_dia(J, {"block_rows": 1024}, interpret=True))(
        jnp.asarray(x)))
    return J, x, y


def test_dia_probe_full_matches_pallas():
    J, x, ref = _dia_case()
    A = port_of(J)
    fn = dia_probe.build_probe(A, 256, "full")
    np.testing.assert_allclose(fn(fn.prepare(torch.from_numpy(x))).numpy(), ref,
                               **DIA_TOL)


@pytest.mark.parametrize("mode", ["noshift", "nodata", "nobounds"])
def test_dia_probe_modes_match_their_definitions(mode):
    """noshift: y[i] = sum_d data[d, i] x[i] (the JAX noshift,
    benchmarks/dia_probe.py:33-34, reads the block's own rows); nodata:
    y[i] = sum of x[i + off] over the offsets in the matrix; nobounds: the
    product through a zero-padded x, equal to the full product."""
    J, x, ref = _dia_case()
    A = port_of(J)
    m, n = A.shape
    data = A.data.double().numpy()
    if mode == "noshift":
        want = data[:, :m].sum(0) * x[:m]
    elif mode == "nodata":
        want = np.array([sum(x[i + off] for off in A.offsets if 0 <= i + off < n)
                         for i in range(m)])
    else:
        want = _dense_dia(A) @ x
    fn = dia_probe.build_probe(A, 128, mode)
    xin = fn.prepare(torch.from_numpy(x))
    if mode == "nobounds":
        left = -min(A.offsets)
        assert xin.shape[0] >= left + m + max(A.offsets)
        np.testing.assert_array_equal(xin[left:left + n].numpy(), x)
        assert not xin[:left].any() and not xin[left + n:].any()
    np.testing.assert_allclose(fn(xin).numpy(), want, **DIA_TOL)


def test_dia_probe_refuses_unknown_modes():
    J, _, _ = _dia_case()
    with pytest.raises(InvalidInputException):
        dia_probe.build_probe(port_of(J), 256, "noroll")(torch.zeros(J.num_cols))


# -- the DIA SpMM probe ---------------------------------------------------------

@functools.cache
def _dia_spmm_case(k):
    J = jgallery.poisson5pt(9, 11, format="dia", dtype=np.float32)
    X = np.random.RandomState(17).randn(J.num_cols, k).astype(np.float32)
    Y = np.asarray(jax.jit(jax_dia(J, {"block_rows": 1024}, interpret=True))(
        jnp.asarray(X)))
    return J, X, Y


@pytest.mark.parametrize("k", [3, 16, 128])
@pytest.mark.parametrize("mode", ["shipped", "team=64", "xtile"])
def test_dia_spmm_probe_matches_jax(mode, k):
    """shipped, team=T and xtile compute the shipped product (JAX: the XLA
    path at k <= 64, the Pallas SpMM kernel at k = 128)."""
    J, X, ref = _dia_spmm_case(k)
    fn = dia_spmm_probe.build_probe(port_of(J), mode)
    Y = fn(torch.from_numpy(X))
    assert Y.shape == ref.shape == (J.num_rows, k)
    np.testing.assert_allclose(Y.numpy(), ref, **DIA_TOL)


@pytest.mark.parametrize("k", [3, 16])
def test_dia_spmm_probe_nodata_is_the_sum_of_shifted_rows(k):
    J, X, _ = _dia_spmm_case(k)
    A = port_of(J)
    m, n = A.shape
    pattern = (_dense_dia(A) != 0).astype(np.float64)
    # where a diagonal's stored value is 0 inside the matrix, nodata still
    # adds the row of X: count each in-matrix slot of each diagonal
    slots = np.zeros((m, n))
    for off in A.offsets:
        for i in range(m):
            if 0 <= i + off < n:
                slots[i, i + off] = 1.0
    assert (slots >= pattern).all()
    Y = dia_spmm_probe.build_probe(A, "nodata")(torch.from_numpy(X))
    np.testing.assert_allclose(Y.numpy(), slots @ X, **DIA_TOL)


def test_dia_spmm_probe_modes():
    assert dia_spmm_probe.MODES == ("shipped", "rows=1", "rows=2", "rows=4",
                                    "team=32", "team=64", "team=128", "xtile",
                                    "nodata")
    with pytest.raises(InvalidInputException):
        dia_spmm_probe.build_probe(None, "team=256")


# -- the routed probe -----------------------------------------------------------

def _staged_mix():
    """2048 x 20000: four entries a row near column 4 r (a block of 256
    rows puts 1024 of them in one 4096-column window), two anywhere, and
    one hub row of 100 entries above hub_cap 32."""
    rng = np.random.RandomState(5)
    m, n = 2048, 20000
    rows = np.repeat(np.arange(m), 6)
    local = (4 * rows + np.tile([0, 1, 2, 3, 0, 0], m)) % n
    anywhere = rng.randint(0, n, rows.size)
    cols = np.where(np.tile([1, 1, 1, 1, 0, 0], m).astype(bool), local, anywhere)
    hub_cols = rng.choice(n, 100, replace=False)
    rows = np.r_[rows, np.full(100, 7)]
    cols = np.r_[cols, hub_cols]
    S = sp.coo_matrix((rng.uniform(-1, 1, rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, n)).tocsr()
    S.sum_duplicates()
    return S


CONFIG = {"hub_cap": 32, "window": 4096, "block_size": 256}


@functools.cache
def _routed_case():
    S = _staged_mix()
    J = jax_from_scipy(S.tocoo(), "csr")
    x = np.random.RandomState(7).randn(J.num_cols).astype(np.float32)
    y = np.asarray(jax.jit(jax_routed(J, {"hub_cap": 32}, interpret=True))(
        jnp.asarray(x)))
    return S, J, x, y


def test_routed_probe_full_matches_pallas():
    S, J, x, ref = _routed_case()
    fn, info = routed_probe.build_probe(port_of(J), CONFIG, "full")
    y = fn(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), ref, **RAIL_TOL)
    hub = S.indptr[8] - S.indptr[7]           # row 7: its six entries and 100 more
    assert hub >= 100 and info["tail_share"] == pytest.approx(hub / S.nnz)
    assert info["long_rows"] == 0 and info["hub_cap"] == 32


def _numpy_modes(S, x, thr):
    """Each mode's definition in numpy, over the rows of at most thr entries
    (own rows); full adds the hub rows, which the tail writes."""
    m, n = S.shape
    indptr, col, val = S.indptr, S.indices, S.data.astype(np.float64)
    out = {k: np.zeros(m) for k in routed_probe.MODES}
    for r in range(m):
        lo, hi = indptr[r], indptr[r + 1]
        c, v = col[lo:hi], val[lo:hi]
        out["full"][r] = float(v @ x[c])
        if hi - lo > thr:                     # a hub row: the tail writes it
            continue
        out["nohub"][r] = out["full"][r]
        out["loads"][r] = float((v + 1e-30 * c).sum())
    return out


@pytest.mark.parametrize("mode", routed_probe.MODES)
def test_routed_probe_modes_match_their_definitions(mode):
    """full: the product; nohub: no tail (hub rows 0); loads: sum of val +
    1e-30 col over the row, hub rows 0 (the JAX loads,
    benchmarks/routed_probe.py:65-66)."""
    S, J, x, _ = _routed_case()
    A = port_of(J)
    fn, info = routed_probe.build_probe(A, CONFIG, mode)
    want = _numpy_modes(S, x, info["hub_cap"])[mode]
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, **RAIL_TOL)
    if mode == "full":
        shipped = build_routed(A, CONFIG)
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   shipped(torch.from_numpy(x)).numpy(), **RAIL_TOL)


def test_routed_probe_modes_follow_the_kernels_order():
    """MODES index rail_rows.cuh's Mode (kFullMode 0, kNoHub 1, kLoads 2);
    an unknown mode raises."""
    assert routed_probe.MODES == ("full", "nohub", "loads")
    with pytest.raises(InvalidInputException):
        routed_probe.build_probe(None, CONFIG, "nostage")


def test_routed_probe_nohub_differs_from_full_on_the_hub_rows_alone():
    S, J, x, _ = _routed_case()
    A = port_of(J)
    xt = torch.from_numpy(x)
    full = routed_probe.build_probe(A, CONFIG, "full")[0](xt).numpy()
    nohub = routed_probe.build_probe(A, CONFIG, "nohub")[0](xt).numpy()
    hub = np.diff(S.indptr) > CONFIG["hub_cap"]
    assert hub.sum() == 1 and (nohub[hub] == 0).all() and full[hub][0] != 0
    assert np.array_equal(nohub[~hub], full[~hub])


def test_routed_probe_plan_is_the_shipped_plan():
    S, J, _, _ = _routed_case()
    A = port_of(J)
    fn, _ = routed_probe.build_probe(A, CONFIG, "loads")
    shipped = build_routed(A, CONFIG).planned_arrays
    for key in ("indptr", "col", "val"):
        assert torch.equal(fn.planned_arrays[key], shipped[key])


# -- the launch floor -----------------------------------------------------------

def test_launch_floor_plain_matches_numpy_f32():
    from cusp_autotuned_tpu_torch.benchmarks import harness
    x = np.random.RandomState(9).randn(8, 128).astype(np.float32)
    y = harness.launch_floor(torch.from_numpy(x))
    want = x * np.float32(1.0000001) + np.float32(0.125)
    assert y.dtype == torch.float32 and y.shape == (8, 128)
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(harness.floor_tile("cpu").numpy(), x)
