"""The per-layer readers on a made-up trace: the product's kernels are the
wrappers that one product alone moved, and every other kernel, a counted
wrapper's too, is the work around it; a driver is found by its kind."""

import pytest

from spbench import generator, harness, readers
from spbench.trace import Trace

KERNELS = {"dia_spmv": ("dia_spmv_kernel",), "stream_triad": ("stream_triad_kernel",)}


def made_up_run(product):
    # 4 SpMVs of 1 ms, 4 triads of 0.5 ms, one torch reduction of 0.25 ms (µs)
    ops, t = [], 0.0
    for _ in range(4):
        ops.append((t, t + 1000.0, "void dia_spmv_kernel<double>(int)"))
        ops.append((t + 1000.0, t + 1500.0, "void stream_triad_kernel(float)"))
        t += 1500.0
    ops.append((t, t + 250.0, "void at::native::reduce_kernel<512, 1>(int)"))
    trace = Trace(ops=ops, host=[], start=0.0, end=t + 250.0)
    traced = dict(counts={"dia_spmv": 4, "stream_triad": 4}, units=2, iterations=2,
                  trace=trace)
    return harness.Run(workload="w", config={}, traffic={}, device_kind="card",
                       peak=None, matrices=[], setup_s=1.0,
                       record={"counts": {"dia_spmv": 8, "stream_triad": 8},
                               "iterations": 4},
                       traced=traced, kernels_of=KERNELS, product=product)


def test_a_counted_kernel_outside_the_product_is_other_work():
    run = made_up_run({"dia_spmv": 1})
    seconds, calls = readers.product_time(run)
    assert seconds == pytest.approx(4e-3) and calls == 4
    assert readers.other_time(run) == pytest.approx(4 * 0.5e-3 + 0.25e-3)
    assert readers.product_calls(run, run.record["counts"]) == 8


def test_two_wrappers_of_one_product():
    run = made_up_run({"dia_spmv": 1, "stream_triad": 1})
    seconds, calls = readers.product_time(run)
    assert seconds == pytest.approx(6e-3) and calls == 4
    assert readers.other_time(run) == pytest.approx(0.25e-3)


def test_no_product_seen_reads_nothing():
    run = made_up_run({})
    assert readers.product_time(run) is None and readers.other_time(run) is None
    assert readers.product_calls(run, run.record["counts"]) is None


@pytest.mark.parametrize("kind", ["cg_solves", "multiply_rounds"])
def test_driver_found_by_kind(kind):
    cfg = {"dtype": "float32"}
    d = generator.driver(cfg, {"kind": kind}, 3, "cpu")
    assert isinstance(d, generator.Base) and type(d).__module__ == f"spbench.drivers.{kind}"


@pytest.mark.parametrize("kind", ["../run", "no_such_kind"])
def test_unknown_kind_is_refused(kind):
    with pytest.raises((ValueError, ModuleNotFoundError)):
        generator.driver({"dtype": "float32"}, {"kind": kind}, 3, "cpu")
