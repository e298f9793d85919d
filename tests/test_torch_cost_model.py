"""The port's take probe and cost model against the JAX package's, on the
CPU.

The take probe's plain version computes the JAX probe's function (the JAX
kernel in Pallas interpret mode) to rtol 1e-6, the JAX package's own bar
(tests/test_calibrate.py:117).  pattern_stats is the JAX package's, key for
key and exact.  The prices themselves are the card's, not the TPU's, so the
parity here is in the decisions that do not depend on them: the DIA fill
guard, and via_dia for a stencil.  The rest holds the port's tuner to its
model: the untuned pick, the dynamic walk's order and ModelGuidedSearcher."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.autotune import calibrate as jcalibrate
from cusp_autotuned_tpu.autotune import cost_model as jcost_model
from cusp_autotuned_tpu.backend.reference import from_scipy as jfrom_scipy
from cusp_autotuned_tpu.gallery.suite import williams_suite as jwilliams_suite

from cusp_autotuned_tpu_torch import autotune, gallery
from cusp_autotuned_tpu_torch.autotune import (
    ModelGuidedSearcher, Tuner, calibrate, configurations_for, cost_model,
)
from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
from cusp_autotuned_tpu_torch.kernels import default_config

from tests.torch_parity import port_of

TAKE_RTOL = 1e-6


@functools.cache
def _planes():
    """The JAX probe's planes and the port's, from one seed."""
    jax_idx = jcalibrate._take_probe_planes(np.random.RandomState(0))
    return jax_idx, calibrate.take_probe_planes(0)


@pytest.mark.parametrize("passes", [3, 18])
def test_take_probe_plain_matches_jax_probe(passes):
    import jax.numpy as jnp
    G = 2
    jax_idx, idx = _planes()
    np.testing.assert_array_equal(idx.numpy(), jax_idx)
    x = np.random.RandomState(1).randn(G * 128, 128).astype(np.float32)
    want = np.asarray(jcalibrate._take_probe_build(passes, jnp.asarray(jax_idx), G)(
        jnp.asarray(x)))
    got = calibrate.take_probe(torch.from_numpy(x), idx, passes)   # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, rtol=TAKE_RTOL)
    # every pass reads the original x through its own plane: a chain of
    # takes (acc = take(acc, plane)) composes the permutations and differs
    L, chained, chain_acc = 128, x.copy(), np.zeros_like(x)
    for p in range(passes):
        planes = np.tile(jax_idx[p * L:(p + 1) * L], (G, 1))
        chained = np.take_along_axis(chained, planes, axis=1)
        chain_acc += chained * (1.0 + 0.001 * p)
    assert not np.allclose(got.numpy(), chain_acc)


def test_take_probe_timing_needs_a_card():
    from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException
    with pytest.raises(InvalidInputException):
        calibrate.tile_take_ns(device="cpu")      # a CPU time is no card's


def _pair(S, dtype=np.float32):
    """One scipy matrix as the JAX package's CSR container and the port's."""
    J = jfrom_scipy(S, "csr", dtype=dtype)
    return J, port_of(J)


@functools.cache
def _stats_cases():
    rng = np.random.RandomState(3)
    suite = jwilliams_suite(0.05)
    return {
        "poisson5pt 30x20": _pair(jgallery.poisson5pt(30, 20, format="coo").to_scipy()),
        "random 400x300": _pair(sp.random(400, 300, density=0.02, random_state=rng)),
        "Economics": _pair(suite["Economics"]),
        "LP": _pair(suite["LP"]),
    }


@pytest.mark.parametrize("name", ["poisson5pt 30x20", "random 400x300",
                                  "Economics", "LP"])
def test_pattern_stats_match_jax(name):
    J, A = _stats_cases()[name]
    want, got = jcost_model.pattern_stats(J), cost_model.pattern_stats(A)
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


def test_recommend_config_picks_via_dia_on_a_stencil():
    """At 300 x 300 and above the card's prices put a 5-point stencil on the
    DIA kernel, as the JAX model does; on a small grid every impl is one
    launch of about the same price and the DIA kernel's loop over its
    diagonals loses its edge (the card's walks agree: PERF.md)."""
    J = jgallery.poisson5pt(300, 300, format="csr", dtype=np.float32)
    A = port_of(J)
    cfg, us = cost_model.recommend_config(A)
    assert cfg == {"impl": "via_dia"} and us > 0
    assert jcost_model.recommend_config(J)[0]["impl"] == "via_dia"
    D = gallery.poisson5pt(300, 300, format="dia", device="cpu")
    assert cost_model.recommend_config(D)[0] == {"impl": "cuda"}


@pytest.mark.parametrize("case", ["stencil", "scattered", "small band"])
def test_dia_fill_guard_matches_jax(case):
    """via_dia is skipped exactly where the JAX model skips it: a fill ratio
    above 3 on more than 1e6 padded values."""
    if case == "stencil":
        S = jgallery.poisson5pt(60, 60, format="coo").to_scipy()
    elif case == "scattered":
        S = sp.random(2000, 2000, density=0.002, random_state=4)
    else:          # ratio above 3 but a padded size below 1e6
        S = sp.diags([np.ones(300 - abs(o)) for o in (-250, 0, 250)],
                     (-250, 0, 250)) + sp.random(300, 300, density=0.01,
                                                 random_state=5)
    J, A = _pair(S)
    want = "skip" in jcost_model.predict(J)["via_dia"]
    assert ("skip" in cost_model.predict(A)["via_dia"]) == want
    assert want == (case == "scattered")


def test_predict_prices_every_rail_and_respects_refusals():
    S = sp.random(3000, 3000, density=0.003, random_state=6, format="csr")
    _, A = _pair(S)
    pred = cost_model.predict(A)
    for impl in ("default", *cost_model.RAILS):
        assert pred[impl]["us"] > 0 and pred[impl]["config"]["impl"] in (
            impl, "segsum")
    assert "skip" in pred["via_dia"] and "skip" in pred["via_dense"]
    # a few hub rows holding most entries: routed refuses, as build_routed does
    H = sp.random(3000, 3000, density=0.001, random_state=7, format="lil")
    H[:4, :] = 1.0
    _, B = _pair(H.tocsr())
    assert "skip" in cost_model.predict(B)["routed"]


def test_best_configuration_untuned_is_the_model_pick():
    A = gallery.poisson5pt(300, 300, format="csr", device="cpu")
    pick = cost_model.recommend_config(A)[0]
    assert Tuner().best_configuration(A) == pick == {"impl": "via_dia"}
    X = torch.ones(A.num_cols, 4)
    assert Tuner().best_configuration(A, X) == default_config(A, X)
    op = autotune.tuned_operator(A)
    assert op.impl == "via_dia"
    x = torch.linspace(0, 1, A.num_cols)
    np.testing.assert_allclose(op(x).numpy(), reference_spmv(A, x), rtol=1e-5,
                               atol=1e-5)


def test_model_guided_searcher_ranks_the_pick_first():
    S = sp.random(2000, 2000, density=0.004, random_state=8, format="csr")
    _, A = _pair(S)
    pick = cost_model.recommend_config(A)[0]
    order = ModelGuidedSearcher(A).order(configurations_for(A))
    assert order[0]["impl"] == pick["impl"]
    assert len(order) == len(configurations_for(A))
    P = gallery.poisson5pt(300, 300, format="csr", device="cpu")
    assert ModelGuidedSearcher(P).order(configurations_for(P))[0]["impl"] == "via_dia"


def test_dynamic_walk_runs_in_model_order():
    A = gallery.poisson5pt(12, 12, format="csr", device="cpu")
    x = torch.linspace(0, 1, A.num_cols)
    tuner = Tuner(measure=False)
    tuner.tune_iteration(A, x)
    first = next(iter(tuner.results.values()))
    assert [r.configuration["impl"] for r in first.values()] == [
        cost_model.recommend_config(A)[0]["impl"]]
    np.testing.assert_allclose(tuner.tune_iteration(A, x).numpy(),
                               reference_spmv(A, x), rtol=1e-5, atol=1e-5)
