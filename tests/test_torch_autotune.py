"""The port's tuner against the JAX package's, on the CPU: the ktt.cu-style
exhaustive walk, the statuses, the dynamic multiply hook, the cache, the
signature, tuned_operator and choose_format, and the calibration's files.

On the CPU every impl runs its plain version, so a walk here checks the
plans and the bookkeeping; the kernels are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cusp_autotuned_tpu as jct
from cusp_autotuned_tpu import gallery as jgallery, solvers as jsolvers
from cusp_autotuned_tpu.autotune.result import TuningResult as JaxTuningResult
from cusp_autotuned_tpu.autotune.tuner import Tuner as JaxTuner
from cusp_autotuned_tpu.kernels.variants import build_spmv as jax_build_spmv
from cusp_autotuned_tpu.solvers.monitor import Monitor as JaxMonitor

from cusp_autotuned_tpu_torch import autotune, gallery, solvers
from cusp_autotuned_tpu_torch.autotune import (
    ConfigurationCount, ConfigurationFraction, DeterministicSearcher,
    RandomSearcher, ResultStatus, Tuner, TuningDuration, calibrate,
    configurations_for,
)
from cusp_autotuned_tpu_torch.autotune import tuner as tuner_mod
from cusp_autotuned_tpu_torch.autotune.space import config_key
from cusp_autotuned_tpu_torch.autotune.tuner import matrix_signature
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.kernels import build_spmv, default_config, variants
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, InvalidInputException, NotImplementedException,
)

from tests.torch_parity import port_of
from tests.util import example_matrices

SKIPPABLE = {ResultStatus.DeviceLimitsExceeded, ResultStatus.CompilationFailed}


@functools.cache
def _scatter_mw():
    """A wide scattered matrix spanning several x windows, as
    tests/test_autotune.py's csr_scatter_mw (2000 x 40000 at density 1.5e-4),
    drawn by index rather than through sp.random, which permutes all 8e7
    cells."""
    rng = np.random.RandomState(3)
    rows, cols = rng.randint(0, 2000, 12000), rng.randint(0, 40000, 12000)
    S = sp.csr_matrix((rng.uniform(-1, 1, 12000).astype(np.float32), (rows, cols)),
                      shape=(2000, 40000))
    S.sum_duplicates()
    return S


def _from_scipy(name, fmt):
    return (lambda: from_scipy(_scipy(name), fmt, device="cpu"),
            lambda: jct.backend.reference.from_scipy(_scipy(name), fmt))


def _scipy(name):
    return _scatter_mw() if name == "scatter_mw" else example_matrices()[name]


# tests/test_autotune.py's _matrices(), built by each package from one
# scipy matrix or generator call: name -> (port constructor, JAX constructor)
MATRICES = {
    "dia_sym": (lambda: gallery.make_diagonal_symmetric_matrix(300, 300, 3, 5,
                                                               device="cpu"),
                lambda: jgallery.make_diagonal_symmetric_matrix(300, 300, 3, 5)),
    "dia_poisson": (lambda: gallery.poisson5pt(17, 19, format="dia", device="cpu"),
                    lambda: jgallery.poisson5pt(17, 19, format="dia")),
    **{f"{fmt}_tri": _from_scipy("tri37", fmt) for fmt in ("csr", "ell", "ellr", "coo")},
    "ell_rand": _from_scipy("rand50x40", "ell"),
    "csr_scatter_mw": _from_scipy("scatter_mw", "csr"),
}


def _x(n, seed=1):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.fixture
def global_tuner(monkeypatch):
    """A fresh validation-only global tuner for the test."""
    t = Tuner(measure=False)
    monkeypatch.setattr(tuner_mod, "_global_tuner", t)
    return t


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_check_all_configurations(name):
    """Every configuration of the port's space validates against the oracle
    or fails with a skippable status (parity: CheckAllConfigurations,
    ktt.cu:84-206; the JAX package's test_check_all_configurations)."""
    A = MATRICES[name][0]()
    x = torch.from_numpy(_x(A.num_cols))
    results = Tuner(measure=False).tune(A, x, reference_computation=reference_spmv)
    assert len(results) == len(configurations_for(A)) <= 48
    assert any(r.status == ResultStatus.Ok for r in results)
    for r in results:
        assert r.status == ResultStatus.Ok or r.status in SKIPPABLE, \
            f"config {r.configuration}: {r.status} {r.error}"


def test_space_sizes_and_axes():
    """Per-format space sizes (PERF.md lists them) and the pinned axes."""
    A = gallery.poisson5pt(8, 8, format="csr", device="cpu")
    sizes = {f: len(configurations_for(convert(A, f)))
             for f in ("dia", "csr", "coo", "ell", "ellr", "hyb")}
    assert sizes == {"dia": 5, "csr": 45, "coo": 45, "ell": 45, "ellr": 45,
                     "hyb": 17}
    for cfg in configurations_for(A):
        assert (cfg["threads_per_row"] == 0) or cfg["impl"] == "binned"
        assert cfg["threads_per_row"] != 32      # a warp a row is `cuda`
        assert (cfg["values_per_thread"] > 0) == (cfg["impl"] == "colsort")
        assert (cfg["vrow_planes"] > 0) == (cfg["impl"] == "colsort2")
        assert (cfg["window"] > 0) == (cfg["impl"] == "routed")
        assert (cfg["block_size"] > 0) == (
            cfg["impl"] in ("cuda", "binned", "colsort", "colsort2", "routed")
            or cfg["dia_impl"] == "cuda")
    assert {c["impl"] for c in configurations_for(convert(A, "hyb"))} == \
        {"default", "via_dia", "cuda", "binned"}


def test_bf16_axis_is_opt_in(monkeypatch):
    from cusp_autotuned_tpu_torch.utils import config as config_mod
    A = gallery.poisson5pt(8, 8, format="csr", device="cpu")
    n0 = len(configurations_for(A))
    monkeypatch.setattr(config_mod.get_config(), "search_low_precision", True)
    cfgs = configurations_for(A)
    bf16 = [c for c in cfgs if c["value_dtype"] == "bfloat16"]
    assert len(cfgs) == n0 + len(bf16) and {c["impl"] for c in bf16} == {"via_dia"}
    results = Tuner(measure=False).tune(
        A, torch.from_numpy(_x(64)), reference_computation=reference_spmv)
    assert all(r.status == ResultStatus.Ok for r in results
               if r.configuration["value_dtype"] == "bfloat16")


def test_validation_rejects_wrong_kernel(monkeypatch):
    A = gallery.poisson5pt(8, 8, format="dia", device="cpu")
    x = torch.ones(64)

    def bad_variant(A, config):
        return lambda x: x[: A.num_rows] * 0 + 42.0

    monkeypatch.setitem(variants.VARIANTS["dia"], "gather", bad_variant)
    tuner = Tuner()
    results = tuner.tune(A, x, reference_computation=reference_spmv)
    by_impl = {r.configuration["impl"]: r.status for r in results}
    assert by_impl["gather"] == ResultStatus.ValidationFailed
    assert by_impl["slices"] == ResultStatus.Ok
    assert tuner.best_configuration(A)["impl"] != "gather"


SHARED = [
    ("dia_sym", {"impl": "slices"}), ("dia_sym", {"impl": "gather"}),
    ("dia_poisson", {"impl": "gather"}),
    ("csr_tri", {"impl": "segsum"}),
    ("csr_tri", {"impl": "via_dia", "dia_impl": "slices"}),
    ("coo_tri", {"impl": "segsum"}), ("ell_tri", {"impl": "gather"}),
    ("ell_rand", {"impl": "gather"}), ("ell_rand", {"impl": "via_dia", "dia_impl": "slices"}),
    ("ellr_tri", {"impl": "rowlen"}), ("ellr_tri", {"impl": "gather"}),
    ("csr_scatter_mw", {"impl": "segsum"}),
]


@pytest.mark.parametrize("name,config", SHARED,
                         ids=[f"{n}-{c['impl']}" for n, c in SHARED])
def test_shared_impls_give_the_jax_y(name, config):
    P, J = (build() for build in MATRICES[name])
    x = _x(J.num_cols, seed=5)
    want = np.asarray(jax_build_spmv(J, config)(jnp.asarray(x)))
    got = build_spmv(P, config)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_hyb_default_gives_the_jax_y():
    S = sp.random(200, 150, density=0.05, random_state=np.random.RandomState(8),
                  dtype=np.float32)
    J = jct.backend.reference.from_scipy(S, "hyb")
    x = _x(150, seed=6)
    want = np.asarray(jax_build_spmv(J, {"impl": "default"})(jnp.asarray(x)))
    got = build_spmv(port_of(J), {"impl": "default"})(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _status_cases():
    rng = np.random.RandomState(0)
    fill = sp.random(2000, 2000, density=0.0006, random_state=rng,
                     dtype=np.float32) + sp.eye(2000, dtype=np.float32)
    dense = sp.csr_matrix(np.random.RandomState(3).randn(60, 60).astype(np.float32))
    return {"via_dia_fill_guard": (fill, {"impl": "via_dia", "dia_impl": "slices"}),
            "via_dense_sparse": (fill, {"impl": "via_dense"}),
            "via_dense_dense": (dense, {"impl": "via_dense"})}


@pytest.mark.parametrize("case", sorted(_status_cases()))
def test_statuses_match_jax(case):
    S, config = _status_cases()[case]
    J = jct.backend.reference.from_scipy(S.tocoo(), "csr")
    x = np.ones(J.num_cols, np.float32)
    want = JaxTuner(measure=False)._execute(J, jnp.asarray(x), config).status
    got = Tuner(measure=False)._execute(port_of(J), torch.from_numpy(x), config).status
    assert got.value == want.value
    assert got == (ResultStatus.Ok if case == "via_dense_dense"
                   else ResultStatus.DeviceLimitsExceeded)


@pytest.mark.parametrize("error,status", [
    (FormatConversionException, ResultStatus.DeviceLimitsExceeded),
    (NotImplementedException, ResultStatus.CompilationFailed),
    (RuntimeError, None),
], ids=["refused-conversion", "not-implemented", "kernel-failure"])
def test_only_unplannable_configurations_are_results(monkeypatch, error, status):
    """A plan the port refuses is a skippable result; any other failure,
    such as a kernel that does not build or launch, stops the walk."""
    A = gallery.poisson5pt(8, 8, format="dia", device="cpu")

    def failing(A, config):
        raise error("cusp_dia_spmv launch failed")

    monkeypatch.setitem(variants.VARIANTS["dia"], "gather", failing)
    tuner = Tuner(measure=False)
    if status is None:
        with pytest.raises(error, match="launch failed"):
            tuner.tune(A, torch.ones(64), reference_computation=reference_spmv)
        return
    results = tuner.tune(A, torch.ones(64), reference_computation=reference_spmv)
    assert {r.configuration["impl"]: r.status for r in results}["gather"] == status


def test_dynamic_tune_iteration_mode(global_tuner):
    """enable() + repeated multiply walks the space one configuration per
    call, then settles on the best (parity: ktt.h:35-43)."""
    A = gallery.make_diagonal_symmetric_matrix(256, 256, 2, 3, device="cpu")
    x = torch.linspace(0, 1, 256)
    expect = reference_spmv(A, x)
    autotune.enable()
    try:
        n_cfg = len(configurations_for(A))
        for _ in range(n_cfg + 3):
            np.testing.assert_allclose(multiply(A, x).numpy(), expect,
                                       rtol=1e-4, atol=1e-4)
        before = dict(global_tuner.results[matrix_signature(A)])
        multiply(A, x, use_autotuning=False)      # the opt-out bypasses it
    finally:
        autotune.disable()
    results = global_tuner.results[matrix_signature(A)]
    assert len(results) == n_cfg and results.keys() == before.keys()


def test_dynamic_hook_takes_2d_x_through_plain_defaults(global_tuner):
    A = gallery.poisson5pt(6, 6, format="csr", device="cpu")
    X = torch.from_numpy(np.random.RandomState(3).randn(36, 4).astype(np.float32))
    autotune.enable()
    try:
        for _ in range(4):
            Y = multiply(A, X)
    finally:
        autotune.disable()
    np.testing.assert_allclose(Y.numpy(), A.to_scipy() @ X.numpy(), rtol=1e-5, atol=1e-5)
    assert "k=4" in matrix_signature(A, X)


def test_fixed_configuration_multiply():
    A = gallery.poisson5pt(10, 10, format="dia", device="cpu")
    x = torch.ones(100)
    y = autotune.multiply(A, x, configuration={"impl": "gather"})
    np.testing.assert_allclose(y.numpy(), reference_spmv(A, x), rtol=1e-6)


def test_cache_survives_a_restart(tmp_path):
    path = str(tmp_path / "tuning.json")
    A = gallery.make_diagonal_symmetric_matrix(200, 200, 1, 3, device="cpu")
    x = torch.ones(200)
    t1 = Tuner(cache_path=path)
    t1.tune(A, x, reference_computation=reference_spmv)
    t2 = Tuner(cache_path=path)
    sig = matrix_signature(A)
    assert set(t2.results[sig]) == set(t1.results[sig])
    assert t2.best_configuration(A) == t1.best_configuration(A)
    # one file layout for both packages
    blob = json.load(open(path))[sig][0]
    assert set(blob) == set(JaxTuningResult.from_json(blob).to_json())


def test_signature_separates_same_shaped_matrices():
    import dataclasses
    S1 = gallery.poisson5pt(9, 9, format="dia", device="cpu")
    S2 = dataclasses.replace(S1, data=S1.data * 2.0)
    assert matrix_signature(S1) != matrix_signature(S2)
    assert matrix_signature(S1).endswith(":cpu")
    tuner = Tuner()
    y1 = tuner.run(S1, torch.ones(81), {"impl": "slices"})
    y2 = tuner.run(S2, torch.ones(81), {"impl": "slices"})
    np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), rtol=1e-6)


def test_signature_follows_in_place_edits(global_tuner):
    """An in-place edit of a container's tensor gives it a new signature,
    so the hook does not serve a plan that copied the old values."""
    A = gallery.poisson5pt(9, 9, format="csr", device="cpu")
    x = torch.linspace(0, 1, 81)
    config = {"impl": "via_dia", "dia_impl": "slices"}
    sig = matrix_signature(A)
    y1 = autotune.multiply(A, x, configuration=config)
    A.val.mul_(2.0)
    assert matrix_signature(A) != sig
    y2 = autotune.multiply(A, x, configuration=config)
    np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), rtol=1e-6)
    assert matrix_signature(A) == matrix_signature(A)


def test_reset_searchers_and_stop_conditions():
    A = gallery.poisson5pt(8, 8, format="dia", device="cpu")
    x = torch.ones(64)
    cfgs = configurations_for(A)
    assert DeterministicSearcher().order(cfgs) == cfgs
    rnd = RandomSearcher(seed=3).order(cfgs)
    assert sorted(map(config_key, rnd)) == sorted(map(config_key, cfgs))
    tuner = Tuner()
    assert len(tuner.tune(A, x, stop_condition=ConfigurationCount(2))) == 2
    tuner.reset_tuning(A)
    assert matrix_signature(A) not in tuner.results
    assert len(tuner.tune(A, x, stop_condition=TuningDuration(0.0))) == 0
    assert len(tuner.tune(A, x, stop_condition=ConfigurationFraction(0.5))) == \
        -(-len(cfgs) // 2)


def test_untuned_best_is_the_default_and_channels_do_not_fall_back():
    """With nothing measured the tuner's best is the cost model's pick for
    a vector x, and the format's default for a dense block x, which the
    model does not price."""
    from cusp_autotuned_tpu_torch.autotune.cost_model import recommend_config
    A = gallery.poisson5pt(8, 8, format="csr", device="cpu")
    assert Tuner().best_configuration(A) == recommend_config(A)[0]
    assert Tuner().best_configuration(A, torch.ones(64, 2)) == default_config(A) == \
        {"impl": "segsum", "dia_impl": "none"}
    with pytest.raises(InvalidInputException):
        Tuner(timing_channel="cuda_events").tune(A, torch.ones(64))
    with pytest.raises(ValueError):
        Tuner(timing_channel="wall")
    with pytest.raises(NotImplementedException):
        autotune.tuned_operator(A, mesh=object())


def test_tuned_operator_cg_matches_jax_iterations(global_tuner):
    """cg.cu at 32 x 32: the walk, the tuned operator and CG give the JAX
    package's iteration count (73)."""
    J = jgallery.poisson5pt(32, 32, format="csr", dtype=np.float32)
    b = np.random.RandomState(0).rand(J.num_rows).astype(np.float32)
    _, mj = jsolvers.cg(J, jnp.asarray(b), monitor=JaxMonitor(jnp.asarray(b), 2000, 1e-5))
    op = autotune.tuned_operator(port_of(J), tune_first=True)
    assert len(global_tuner.results[matrix_signature(port_of(J))]) == 45
    bt = torch.from_numpy(b)
    _, mp = solvers.cg(op, bt, monitor=Monitor(bt, 2000, 1e-5))
    assert mp.iteration_count() == mj.iteration_count() == 73


def test_choose_format_ranks_on_the_tuned_field():
    A = gallery.make_diagonal_symmetric_matrix(256, 256, 2, 5, device="cpu")
    x = torch.ones(256)
    tuner = Tuner(warmup=0, repeats=2)
    B, config = autotune.choose_format(convert(A, "csr"), x, formats=("csr", "dia", "ell"),
                                       reference_computation=reference_spmv,
                                       tuner=tuner)
    best = min((r for sig in tuner.results.values() for r in sig.values()
                if r.is_valid()), key=lambda r: r.duration_ms)
    assert config == best.configuration
    assert tuner.best_configuration(B, x) == config
    np.testing.assert_allclose(build_spmv(B, config)(x).numpy(),
                               reference_spmv(A, x), rtol=1e-4, atol=1e-4)


def test_calibration_files_and_triad_plain(tmp_path, monkeypatch):
    path = str(tmp_path / "model.json")
    consts = {"stream_gbps": 3000.0, "gather_ns": 0.5, "segsum_ns": 0.25}
    calibrate.save(consts, "Card A", path)
    assert calibrate.load("Card A", path) == consts
    assert calibrate.load("Card B", path) is None
    monkeypatch.setenv("CUSP_TORCH_CALIBRATION", path)
    assert calibrate.default_path("Card A") == path
    x, y = torch.arange(10.0), torch.ones(10)
    before = calibrate.stream_triad.launches
    calibrate.stream_triad(x, y)
    assert torch.equal(y, 0.5 + 0.25 * torch.arange(10.0))
    assert calibrate.stream_triad.launches == before
    with pytest.raises(InvalidInputException):
        calibrate.stream_gbps(device="cpu")     # a CPU rate is no card's
