"""The port's measurement helpers against the JAX repository's on the CPU:
the useful-byte models (benchmarks/bytes_per_spmv.py), l2_error
(benchmarks/harness.py:260), the roofline report (as tests/test_aux.py:47
checks it), and every timing entry point refusing a CPU device: a CPU
time never stands in for the card's."""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.ops.convert import convert as jax_convert

from cusp_autotuned_tpu_torch import bench, gallery
from cusp_autotuned_tpu_torch.benchmarks import (
    dia_probe, dia_spmm_probe, harness, routed_probe,
)
from cusp_autotuned_tpu_torch.benchmarks.bytes_per_spmv import (
    bytes_per_spmv, flops_per_spmv,
)
from cusp_autotuned_tpu_torch.utils import profiling
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

from tests.torch_parity import one_thread, port_of  # noqa: F401

sys.path.insert(0, ".")
from benchmarks import bytes_per_spmv as jax_bytes  # noqa: E402
from benchmarks.harness import l2_error as jax_l2_error  # noqa: E402

FORMATS = ("coo", "csr", "dia", "ell", "ellr", "hyb")


def _pair(fmt):
    J = jax_convert(jgallery.poisson5pt(20, 30, format="coo", dtype=np.float32), fmt)
    return J, port_of(J)


def _padding_difference(J, P):
    """The JAX count minus the port's, as bytes_per_spmv.py's docstring
    states it: ELL/ELLR slots (and ELLR's row lengths) over rows_padded
    where the port keeps m rows; HYB through its ELL part."""
    if J.format == "hyb":
        return _padding_difference(J.ell, P.ell)
    if J.format not in ("ell", "ellr"):
        return 0
    pad = J.rows_padded - P.num_rows
    vsize = np.dtype(J.dtype).itemsize
    return pad * J.width * (4 + vsize) + (pad * 4 if J.format == "ellr" else 0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_bytes_and_flops_match_the_jax_models(fmt):
    J, P = _pair(fmt)
    jb, pb = jax_bytes.bytes_per_spmv(J), bytes_per_spmv(P)
    assert jb - pb == _padding_difference(J, P)
    if fmt in ("coo", "csr", "dia"):
        assert pb == jb
    assert flops_per_spmv(P) == jax_bytes.flops_per_spmv(J) == 2 * J.nnz


def test_l2_error_matches_the_jax_harness():
    rng = np.random.RandomState(4)
    y, ref = rng.randn(300).astype(np.float32), rng.randn(300).astype(np.float32)
    assert harness.l2_error(torch.from_numpy(y), torch.from_numpy(ref)) == \
        pytest.approx(jax_l2_error(y, ref), rel=1e-12)
    assert harness.l2_error(y, np.zeros(300)) == jax_l2_error(y, np.zeros(300))


def test_roofline_report_counts_min_read_bytes(monkeypatch):
    """profile_spmv's report, as tests/test_aux.py:47 checks the JAX one.
    The CPU cannot time the card, so the timer here is a stand-in that
    returns 10 us; profile_spmv itself refuses the CPU (below)."""
    A = gallery.poisson5pt(30, 30, format="dia", device="cpu")
    x = torch.ones(A.num_cols)
    monkeypatch.setattr(harness, "card", lambda args=(), device=None: x.device)
    monkeypatch.setattr(harness, "time_fn", lambda f, *a, **k: (f(*a), 1e-5)[1])
    rep = profiling.profile_spmv(A, x, stream_gbps=3000.0)
    assert rep.model_bytes == profiling.min_read_bytes(A) == bytes_per_spmv(A)
    assert rep.time_us == pytest.approx(10.0)
    assert rep.achieved_gbps == pytest.approx(rep.model_bytes / 1e-5 / 1e9)
    assert rep.roofline_fraction == pytest.approx(rep.achieved_gbps / 3000.0)
    assert np.isfinite(rep.roofline_fraction) and "GB/s" in str(rep)


def test_speed_of_light_is_the_cost_models_price():
    from cusp_autotuned_tpu_torch.autotune import cost_model
    A = gallery.poisson5pt(30, 30, format="csr", device="cpu")
    pred = cost_model.predict(A, allow_low_precision=True)
    sol = profiling.kernel_speed_of_light(A, {"impl": "via_dia"})
    assert sol["label"] == "via_dia" and sol["pred_us"] == pred["via_dia"]["us"]
    assert profiling.kernel_speed_of_light(A, {"impl": "segsum"})["label"] == "default"
    assert profiling.kernel_speed_of_light(
        A, {"impl": "via_dia", "value_dtype": "bfloat16"})["label"] == "via_dia_bf16"


def _cpu_calls():
    x = torch.ones(8)
    A = gallery.poisson5pt(10, 10, format="csr", device="cpu")
    xa = torch.ones(A.num_cols)
    return {
        "time_fn": lambda: harness.time_fn(lambda v: v * 2, x),
        "time_fn closure": lambda: harness.time_fn(lambda: x * 2, device="cpu"),
        "graph_time_s": lambda: harness.graph_time_s(lambda v: v * 2, x),
        "time_fn_marginal": lambda: harness.time_fn_marginal(lambda v: v * 2, x),
        "stream_bandwidth_gbps": lambda: harness.stream_bandwidth_gbps("cpu"),
        "launch_floor_s": lambda: harness.launch_floor_s("cpu"),
        "profile_spmv": lambda: profiling.profile_spmv(A, xa, stream_gbps=1.0),
        "time_cold": lambda: harness.time_cold(
            lambda i: (lambda v: v * 2, (x,)), 32, device="cpu"),
        "cold_call": lambda: harness.cold_call(
            lambda i: (lambda v: v * 2, (x,)), 32, device="cpu"),
    }


@pytest.mark.parametrize("name", sorted(_cpu_calls()))
def test_timing_entry_points_refuse_the_cpu(name):
    with pytest.raises(InvalidInputException):
        _cpu_calls()[name]()


@pytest.mark.parametrize("main", [dia_probe.main, dia_spmm_probe.main,
                                  routed_probe.main, bench.main],
                         ids=["dia_probe", "dia_spmm_probe", "routed_probe", "bench"])
def test_probe_mains_need_a_card(main, monkeypatch):
    """With no card named, each main resolves the CUDA device, which raises
    where torch sees none, before it builds or times anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidInputException):
        main()


def _tensors(M):
    """Every tensor of the container M, those of its parts too."""
    out = []
    for f in dataclasses.fields(M):
        v = getattr(M, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += _tensors(v)
    return out


@pytest.mark.parametrize("fmt", ["csr", "dia", "hyb"])
def test_fresh_copies_own_every_tensor(fmt):
    """harness.fresh, which gives time_cold's copies: equal values, no
    storage shared with the original, metadata kept."""
    A = gallery.poisson5pt(6, 7, format=fmt, device="cpu")
    B = harness.fresh(A)
    ta, tb = _tensors(A), _tensors(B)
    assert len(ta) == len(tb) > 0 and B.shape == A.shape and B.nnz == A.nnz
    for a, b in zip(ta, tb):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    d = harness.fresh({"w": (torch.ones(3), [torch.zeros(2)]), "n": 5})
    assert d["n"] == 5 and torch.equal(d["w"][1][0], torch.zeros(2))
