"""The port's routed rail against the JAX package's Pallas routed rail, on
the CPU.

On the CPU the routed wrappers take their kernels' plain PyTorch version:
each row of at most hub_cap entries summed with a gather and an
index_add_, the longer rows (the tail) through the colsort2 hub region.  It
is held here against `cusp_autotuned_tpu.kernels.pallas_routed.build_routed`
run in interpret mode, on the shapes of tests/test_pallas.py (:827, :835,
:925, :942), at that file's tolerance (rtol 1e-4, atol 1e-4; :161): the
same scipy triplets and the same numpy x go to both packages, and both
refuse the tail-dominant pattern.  The CUDA kernels are held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_routed import build_routed as jax_routed
from cusp_autotuned_tpu.utils.exceptions import (
    FormatConversionException as JaxFormatConversionException,
)

from cusp_autotuned_tpu_torch.autotune import (
    ResultStatus, Tuner, configurations_for,
)
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.kernels import build_spmv, tuning_space
from cusp_autotuned_tpu_torch.kernels.colsort2 import colsort2_hub
from cusp_autotuned_tpu_torch.kernels.routed import build_routed, routed_spmv
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, NotImplementedException,
)

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.test_torch_rails import _powerlaw

TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_pallas.py:161


def _random_scatter():
    rng = np.random.RandomState(11)
    return (sp.random(4000, 4000, density=6e-4, random_state=rng, dtype=np.float32)
            + sp.eye(4000, dtype=np.float32))


def _hub_row():
    rng = np.random.RandomState(3)
    S = sp.random(3000, 3000, density=8e-4, random_state=rng, dtype=np.float32)
    hub = sp.coo_matrix((rng.randn(400).astype(np.float32),
                         (np.full(400, 7), rng.choice(3000, 400, replace=False))),
                        shape=(3000, 3000))
    return (S + hub).tocsr()


def _rectangular():
    return sp.random(3000, 5000, density=5e-4, random_state=np.random.RandomState(9),
                     dtype=np.float32)


# name -> (scipy matrix, JAX config, port config), as tests/test_pallas.py
CASES = {
    "random_scatter": (_random_scatter, {}, {}),
    "hub_row_tail": (_hub_row, {"hub_cap": 32}, {"hub_cap": 32, "window": 4096}),
    "rectangular": (_rectangular, {}, {"window": 8192, "block_size": 512}),
}


@functools.cache
def _jax_case(name, k=0):
    """(JAX matrix, x or X, y of the JAX routed rail in interpret mode)."""
    make, jcfg, _ = CASES[name]
    J = jax_from_scipy(make().tocoo(), "csr")
    rng = np.random.RandomState(7)
    shape = (J.num_cols,) if k == 0 else (J.num_cols, k)
    x = rng.randn(*shape).astype(np.float32)
    fn = jax_routed(J, jcfg, interpret=True)
    y = jax.jit(fn)(jnp.asarray(x)) if k == 0 else fn(jnp.asarray(x))
    return J, x, np.asarray(y)


@pytest.mark.parametrize("name", sorted(CASES))
def test_routed_plain_matches_pallas(name):
    J, x, ref = _jax_case(name)
    fn = build_routed(port_of(J), CASES[name][2])
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref, **TOL)
    assert (fn.plan_stats["tail"] > 0) == (name == "hub_row_tail")


@pytest.mark.parametrize("name,k", [("rectangular", 5), ("rectangular", 3),
                                    ("hub_row_tail", 16)])
def test_routed_spmm_plain_matches_pallas(name, k):
    J, X, ref = _jax_case(name, k)
    Y = build_routed(port_of(J), CASES[name][2])(torch.from_numpy(X))
    assert Y.shape == ref.shape == (J.num_rows, k)
    np.testing.assert_allclose(Y.numpy(), ref, **TOL)


def test_tail_dominant_pattern_is_refused_by_both():
    """tests/test_pallas.py:942: 56 % of the entries lie in rows above the
    default hub_cap, so the tail would hold more than half of them."""
    S = _powerlaw(3000, 15000, seed=1).tocoo().astype(np.float32)
    J = jax_from_scipy(S, "csr")
    with pytest.raises(JaxFormatConversionException):
        jax_routed(J, {}, interpret=True)
    with pytest.raises(FormatConversionException, match="tail"):
        build_routed(port_of(J), {})
    lengths = np.diff(S.tocsr().indptr)
    assert 0.5 < lengths[lengths > 64].sum() / lengths.sum() < 0.6


def test_routed_sorts_unsorted_rows_and_refuses_bad_configs():
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    indptr = np.array([0, 3, 5])
    A = csr_matrix(indptr, np.array([4, 0, 2, 3, 1]), np.arange(1.0, 6.0),
                   (2, 5), dtype=torch.float32, device="cpu")
    fn = build_routed(A, {})
    assert fn.planned_arrays["col"].tolist() == [0, 2, 4, 1, 3]
    assert fn.planned_arrays["val"].tolist() == [2.0, 3.0, 1.0, 5.0, 4.0]
    x = torch.arange(5.0)
    np.testing.assert_allclose(fn(x).numpy(), reference_spmv(A, x))
    with pytest.raises(NotImplementedException):
        build_routed(A, {"block_size": 1000})
    # the JAX rail's window is a TPU key: accepted and ignored
    same = build_routed(A, {"window": 1000}).planned_arrays
    assert all(torch.equal(same[key], fn.planned_arrays[key])
               for key in ("indptr", "col", "val", "long"))
    with pytest.raises(FormatConversionException):
        build_spmv(from_scipy(sp.coo_matrix((6, 7), dtype=np.float32), "csr",
                              device="cpu"), {"impl": "routed"})


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "ellr"])
def test_space_offers_both_rails_and_every_configuration_plans(fmt):
    """Every configuration of the new impls plans, or is a refused
    conversion; the walk is 41 configurations for coo, 45 for the formats
    whose walk takes rcm_dia too."""
    S = _powerlaw(400, 2400, seed=6)
    A = from_scipy(S if fmt != "ell" else _random_scatter(), fmt,
                   dtype=torch.float32, device="cpu")
    cfgs = configurations_for(A)
    assert len(cfgs) == (41 if fmt == "coo" else 45)
    impls = {c["impl"] for c in cfgs}
    assert {"colsort2", "routed"} <= impls == set(tuning_space(A).parameters[0].values)
    for cfg in cfgs:
        if cfg["impl"] not in ("colsort2", "routed"):
            continue
        assert cfg["block_size"] in (256, 512)
        assert (cfg["vrow_planes"] > 0) == (cfg["vrow_len"] > 0) == \
            (cfg["impl"] == "colsort2")
        assert "window" not in cfg
        try:
            build_spmv(A, cfg)
        except FormatConversionException:
            assert cfg["impl"] == "routed"


def test_cpu_walk_records_the_new_rails():
    """A walk on a small scattered matrix validates colsort2 and routed;
    on the tail-dominant one routed is a refused conversion."""
    for S, routed_ok in ((_hub_row(), True),
                         (_powerlaw(3000, 15000, seed=1).astype(np.float32), False)):
        A = from_scipy(S, "csr", dtype=torch.float32, device="cpu")
        x = torch.from_numpy(np.random.RandomState(2).randn(A.num_cols)
                             .astype(np.float32))
        results = Tuner(measure=False).tune(A, x, reference_computation=reference_spmv)
        for r in results:
            impl = r.configuration["impl"]
            if impl == "colsort2" or (impl == "routed" and routed_ok):
                assert r.status == ResultStatus.Ok, (r.configuration, r.error)
            elif impl == "routed":
                assert r.status == ResultStatus.DeviceLimitsExceeded
                assert "tail" in r.error


def test_routed_counts_no_launch_on_the_cpu():
    fn = build_routed(port_of(_jax_case("hub_row_tail")[0]), {"hub_cap": 32})
    before = routed_spmv.launches, colsort2_hub.launches
    fn(torch.ones(3000))
    fn(torch.ones(3000, 2))
    assert (routed_spmv.launches, colsort2_hub.launches) == before
