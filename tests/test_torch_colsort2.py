"""The port's colsort2 rail against the JAX package's Pallas colsort2, on the
CPU.

On the CPU the colsort2 wrappers take their kernels' plain PyTorch version:
each row of at most thr entries summed per plane and the planes added in
order, the hub rows through their virtual rows.  It is held here against
`cusp_autotuned_tpu.kernels.pallas_colsort2.build_colsort2` run in
interpret mode, on the shapes and configurations of tests/test_pallas.py,
at that file's tolerance (rtol 1e-4, atol 1e-4; :161): the same scipy
triplets and the same numpy x go to both packages.  So this checks the
plans and the bookkeeping; the CUDA kernels are held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_colsort2 import build_colsort2 as jax_colsort2

from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.kernels import build_spmv
from cusp_autotuned_tpu_torch.kernels.colsort2 import (
    HUB_SPLIT, SHORT_ROW, build_colsort2, colsort2_hub, colsort2_spmv, long_rows,
    plan_colsort2,
)
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.test_torch_rails import _powerlaw

TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_pallas.py:161


def _random(m, n, density, seed, eye=False):
    S = sp.random(m, n, density=density, random_state=np.random.RandomState(seed))
    return (S + sp.eye(m, n) if eye else S).tocsr()


# name -> (scipy matrix, JAX config, port config), as tests/test_pallas.py
# builds them (:541, :546, :559, :576)
CASES = {
    "poisson9": (lambda: jgallery.poisson9pt(35, 35, format="csr").to_scipy(),
                 {}, {}),
    "powerlaw_hub": (lambda: _powerlaw(800, 8000, seed=3),
                     {"hub_cap": 8}, {"hub_cap": 8}),
    "planes1": (lambda: _random(700, 700, 0.02, 11, eye=True),
                {"vrow_planes": 1}, {"vrow_planes": 1}),
    "planes4": (lambda: _random(700, 700, 0.02, 11, eye=True),
                {"vrow_planes": 4}, {"vrow_planes": 4, "vrow_len": 8}),
    "rect_wide": (lambda: _random(300, 900, 0.02, 13), {}, {"vrow_len": 8}),
    "rect_tall": (lambda: _random(900, 300, 0.02, 14), {}, {"vrow_planes": 1}),
}


@functools.cache
def _jax_case(name, k=0):
    """(JAX matrix, x or X, y of the JAX colsort2 in interpret mode); k = 0
    is a vector, else a block of k columns through the SpMM site."""
    make, jcfg, _ = CASES[name]
    J = jax_from_scipy(make().tocoo(), "csr")
    rng = np.random.RandomState(7)
    if k == 0:
        x = rng.randn(J.num_cols).astype(np.float32)
        y = jax.jit(jax_colsort2(J, jcfg, interpret=True))(jnp.asarray(x))
    else:
        x = rng.randn(J.num_cols, k).astype(np.float32)
        y = jax_colsort2(J, {**jcfg, "spmm_kb": 4}, interpret=True)(jnp.asarray(x))
    return J, x, np.asarray(y)


@pytest.mark.parametrize("name", sorted(CASES))
def test_colsort2_plain_matches_pallas(name):
    J, x, ref = _jax_case(name)
    fn = build_colsort2(port_of(J), CASES[name][2])
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("name", ["powerlaw_hub", "rect_wide"])
def test_colsort2_spmm_plain_matches_pallas(name, k):
    J, X, ref = _jax_case(name, k)
    Y = build_colsort2(port_of(J), CASES[name][2])(torch.from_numpy(X))
    assert Y.shape == ref.shape == (J.num_rows, k)
    np.testing.assert_allclose(Y.numpy(), ref, **TOL)


def test_plan_cuts_rows_into_planes_and_the_hub_region():
    lengths = np.array([0, 1, 8, 9, 16, 17, 300, 129, 5])
    indptr = np.r_[0, np.cumsum(lengths)]
    thr, V, (rows, ptr, lo, hi) = plan_colsort2(indptr, K=2, V=8, hub_cap=64)
    assert (thr, V) == (16, 8)
    # rows above K V = 16 entries, longest first, in virtual rows of 128
    assert rows.tolist() == [6, 7, 5]
    assert np.diff(ptr).tolist() == [3, 2, 1]
    assert (hi - lo).tolist() == [128, 128, 44, 128, 1, 17]
    assert lo[0] == indptr[6] and hi[2] == indptr[7] and lo[5] == indptr[5]
    # defaults: the JAX hub_cap max(64, 4 nnz / m) = 4 * 485 // 9 and
    # V = ceil(hub_cap / K)
    thr, V, hub = plan_colsort2(indptr, K=4)
    assert (thr, V, hub[0].tolist()) == (215, 54, [6])
    # the main rows above SHORT_ROW entries take a warp each
    assert long_rows(indptr, 215).tolist() == [7] and SHORT_ROW == 32
    assert HUB_SPLIT == 128


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "ellr", "hyb"])
@pytest.mark.parametrize("impl", ["colsort2", "routed"])
def test_new_rails_through_the_registry(fmt, impl):
    """build_spmv plans both rails from every format's stored entries (ELL's
    -1 slots never reach a gather), for a vector and a block."""
    S = _random(300, 300, 0.02, 5, eye=True).tocoo()
    S.data[::7] = 0.0                        # explicit zeros stay entries
    A = from_scipy(S, fmt, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(1)
    for x in (torch.from_numpy(rng.randn(300).astype(np.float32)),
              torch.from_numpy(rng.randn(300, 3).astype(np.float32))):
        y = build_spmv(A, {"impl": impl})(x)
        np.testing.assert_allclose(y.numpy(), reference_spmv(A, x), **TOL)


def test_colsort2_refuses_what_it_cannot_plan():
    empty = from_scipy(sp.coo_matrix((6, 7), dtype=np.float32), "csr", device="cpu")
    with pytest.raises(FormatConversionException):
        build_spmv(empty, {"impl": "colsort2"})
    A = from_scipy(_random(60, 60, 0.1, 2), "csr", dtype=torch.float32, device="cpu")
    for bad in ({"vrow_planes": 9}, {"vrow_planes": 8, "block_size": 128},
                {"block_size": 100}):
        with pytest.raises(NotImplementedException):
            build_spmv(A, {"impl": "colsort2", **bad})
    fn = build_spmv(A, {"impl": "colsort2"})
    with pytest.raises(NotImplementedException):
        fn(torch.ones(60, 2, 1))
    with pytest.raises(InvalidInputException):
        fn(torch.ones(60, device="meta"))


def test_colsort2_stores_bf16_and_ignores_tpu_keys():
    A = from_scipy(_powerlaw(500, 4000, seed=2), "csr", dtype=torch.float32,
                   device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(500).astype(np.float32))
    tpu = {"block_entries": 2048, "mix_chunks": 4, "pack16": 1, "lane_cap": 2,
           "scatter_dot": "bf16", "stream_x": 1, "spmm_kb": 4, "vrow_span": 64}
    np.testing.assert_allclose(build_colsort2(A, tpu)(x).numpy(),
                               reference_spmv(A, x), **TOL)
    fn = build_spmv(A, {"impl": "colsort2", "value_dtype": "bfloat16"})
    assert fn.planned_arrays["val"].dtype == torch.bfloat16
    y, ref = fn(x), reference_spmv(A, x)
    assert y.dtype == torch.float32
    assert np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref) < 2e-2


def test_colsort2_counts_no_launch_on_the_cpu():
    A = from_scipy(_powerlaw(300, 3000, seed=4), "csr", dtype=torch.float32,
                   device="cpu")
    before = colsort2_spmv.launches, colsort2_hub.launches
    fn = build_colsort2(A, {"hub_cap": 8})
    assert fn.plan_stats["hub_rows"] > 0
    fn(torch.ones(300))
    fn(torch.ones(300, 2))
    assert (colsort2_spmv.launches, colsort2_hub.launches) == before
