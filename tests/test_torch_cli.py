"""The port's offline tuning CLI (python -m cusp_autotuned_tpu_torch.autotune)
against the JAX package's, on the CPU (--device cpu), and the tuner's
progress log.

The loader gives the JAX CLI's matrix for each kind of argument; the JSON
line has the JAX CLI's keys, read from one JAX run cut by a 0.01 s budget
on poisson5pt:8 in DIA (a full JAX walk compiles one executable a
configuration, and the JAX csr space takes ~100 s to enumerate); the
winner matches the scipy oracle; a budget that cuts the walk adds the
coverage note; --choose-format names a valid format."""

import json

import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import gallery as jgallery, io as jio
from cusp_autotuned_tpu.autotune import __main__ as jcli
from cusp_autotuned_tpu.autotune import tuner as jtuner_mod
from cusp_autotuned_tpu.backend.reference import (
    from_scipy as jfrom_scipy, to_scipy as jto_scipy)
from cusp_autotuned_tpu.gallery.suite import williams_suite as jwilliams_suite
from cusp_autotuned_tpu.utils import config as jconfig

from cusp_autotuned_tpu_torch.autotune import TUNABLE_FORMATS, Tuner
from cusp_autotuned_tpu_torch.autotune import __main__ as cli
from cusp_autotuned_tpu_torch.autotune import tuner as tuner_mod
from cusp_autotuned_tpu_torch.backend.reference import reference_spmv, to_scipy
from cusp_autotuned_tpu_torch.gallery import poisson5pt
from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

from tests.torch_parity import one_thread  # noqa: F401

SUITE_SCALE = 0.02


@pytest.fixture
def fresh_tuners(monkeypatch):
    """Both packages' global tuners fresh for the test, and restored after
    (the CLIs set the global tuner's log sink)."""
    monkeypatch.setattr(jtuner_mod, "_global_tuner", None)
    monkeypatch.setattr(tuner_mod, "_global_tuner", None)


def run(argv, capsys):
    """The port CLI's JSON line for argv, on the CPU."""
    capsys.readouterr()
    assert cli.main([*argv, "--json", "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out)


def jax_loader(spec, fmt, dtype):
    """The JAX CLI's matrix for a spec (cusp_autotuned_tpu/autotune/__main__.py)."""
    if spec.startswith("poisson5pt:"):
        nx, _, ny = spec.split(":", 1)[1].partition("x")
        return jgallery.poisson5pt(int(nx), int(ny or nx), format=fmt, dtype=dtype)
    if spec.startswith("suite:"):
        _, name, scale = spec.split(":")
        S = jwilliams_suite(float(scale))[name]
        return jfrom_scipy(S.tocoo().astype(dtype), fmt)
    if spec.endswith(".bin"):
        return jio.read_binary_file(spec, format=fmt)
    return jio.read_matrix_market_file(spec, format=fmt, dtype=dtype)


@pytest.mark.parametrize("kind", ["poisson", "suite", "mtx", "bin"])
def test_loader_gives_the_jax_matrix(kind, tmp_path):
    source = jgallery.poisson5pt(5, 4, format="coo", dtype=np.float64)
    spec, fmt, dtype = {
        "poisson": ("poisson5pt:7x5", "csr", "float32"),
        "suite": (f"suite:Economics:{SUITE_SCALE}", "coo", "float32"),
        "mtx": (str(tmp_path / "A.mtx"), "ell", "float64"),
        "bin": (str(tmp_path / "A.bin"), "hyb", "float32"),
    }[kind]
    jio.write_matrix_market_file(source, str(tmp_path / "A.mtx"))
    with open(tmp_path / "A.bin", "wb") as f:    # a path gets numpy's .npz suffix
        jio.write_binary_stream(source, f)
    want = jax_loader(spec, fmt, np.dtype(dtype))
    got = cli.load_matrix(spec, fmt, dtype, device="cpu")
    assert got.format == want.format == fmt
    assert got.shape == tuple(want.shape) and got.nnz == want.nnz
    W, G = jto_scipy(want).tocsr(), to_scipy(got).tocsr()
    assert G.dtype == W.dtype
    np.testing.assert_array_equal(G.toarray(), W.toarray())


def test_unknown_suite_name_is_a_usage_error(capsys):
    with pytest.raises(SystemExit):
        cli.main(["suite:Nope", "--device", "cpu"])
    assert "unknown suite matrix" in capsys.readouterr().err


def test_json_has_the_jax_cli_keys(capsys, monkeypatch, fresh_tuners):
    # the JAX CLI turns on XLA's persistent cache in the user's home
    monkeypatch.setattr(jconfig, "enable_compile_cache", lambda *a, **k: None)
    capsys.readouterr()
    # DIA: the JAX package's csr space alone takes ~100 s to enumerate here;
    # the port's csr space (45 configurations) outlasts the budget, where
    # its 5 DIA ones may not
    assert jcli.main(["poisson5pt:8", "--format", "dia", "--budget", "0.01",
                      "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    got = run(["poisson5pt:8", "--budget", "0.01"], capsys)
    assert set(got) == set(want)
    assert set(got["coverage"]) == set(want["coverage"])
    assert set(got["results"][0]) == set(want["results"][0]) - {"device_us"}
    assert got["order"] == want["order"] == "model"


def test_walk_covers_the_space_and_the_winner_matches_the_oracle(capsys, fresh_tuners):
    out = run(["poisson5pt:8"], capsys)
    assert out["configs"] == out["space_size"] and "coverage" not in out
    assert out["channel"] == "wall" and out["shape"] == [64, 64] and out["nnz"] == 288
    assert {r["status"] for r in out["results"]} <= {"Ok", "DeviceLimitsExceeded"}
    assert all(r["config"]["impl"] != "cusparse" for r in out["results"])
    A = poisson5pt(8, 8, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(64).astype(np.float32))
    y = build_spmv(A, out["best"])(x)
    np.testing.assert_allclose(y.numpy(), reference_spmv(A, x), rtol=1e-5, atol=1e-5)


def test_a_budget_that_cuts_the_walk_adds_coverage(capsys, fresh_tuners):
    out = run(["poisson5pt:8", "--budget", "0.01"], capsys)
    assert out["budget_s"] == 0.01 and out["configs"] < out["space_size"]
    note = out["coverage"]
    assert note["unwalked"] == out["space_size"] - out["configs"]
    assert note["unwalked_predicted_worse"] == (
        note["model_best_unwalked_us"] >= note["model_best_walked_us"])


@pytest.mark.parametrize("order", ["deterministic", "random"])
def test_order_is_recorded(order, capsys, fresh_tuners):
    out = run(["poisson5pt:6", "--order", order, "--budget", "0.01"], capsys)
    assert out["order"] == order and "coverage" in out


def test_choose_format_names_a_valid_format(capsys, fresh_tuners):
    out = run(["poisson5pt:6", "--choose-format"], capsys)
    assert out["best_format"] in TUNABLE_FORMATS
    A = convert(poisson5pt(6, 6, device="cpu"), out["best_format"])
    x = torch.linspace(-1, 1, 36)
    y = build_spmv(A, out["best_format_config"])(x)
    np.testing.assert_allclose(y.numpy(), reference_spmv(A, x), rtol=1e-5, atol=1e-5)


def test_table_and_progress_log(capsys, fresh_tuners):
    assert cli.main(["poisson5pt:6", "--device", "cpu", "--budget", "0.01"]) == 0
    out = capsys.readouterr()
    assert " Ok; best: " in out.out
    assert out.err.count("[tune csr:36x36") >= 1


def test_asking_for_the_card_without_a_gpu_raises(fresh_tuners):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(InvalidInputException):
        cli.main(["poisson5pt:6", "--json"])


def test_log_fn_gets_one_line_a_configuration_and_changes_no_ranking():
    A = poisson5pt(6, 6, device="cpu")
    x = torch.linspace(-1, 1, 36)
    lines = []
    logged = Tuner(measure=False, log_fn=lines.append)
    results = logged.tune(A, x, reference_computation=reference_spmv)
    assert len(lines) == len(results) > 0
    assert all(line.startswith("[tune csr:36x36") for line in lines)
    assert [r.status for r in results] == [
        r.status for r in Tuner(measure=False).tune(
            A, x, reference_computation=reference_spmv)]
