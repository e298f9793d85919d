"""One run of one cell: find the cell, its configuration, its traffic mix,
its limits and its metrics by name, drive the program, and build the
result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name BENCHMARK.json gives it:

    configuration   the `file` of its BENCHMARK.json entry
    traffic mix     spbench/traffic/<traffic>.json, whose `kind` names its
                    driver, spbench/drivers/<kind>.py
    cell's limits   spbench/limits/<workload>.json
    metric          spbench/metrics/<metric>.py, whose read(run) returns
                    the value or None where it finds nothing to read

A run: set-up (inputs, plan, warm-up), with --trace 1 a traced step of
the cell's own work and the host's enqueue timing, the measured window,
the device's peak memory, the program's state freed, then the comparison
with the reference.  Only then are the metrics read."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from spbench import counts, generator, trace as tracing

SPBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SPBENCH)
BANNED = ("jax", "jaxlib", "flax", "cusp_autotuned_tpu")


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    workload: str
    config: dict
    traffic: dict
    device_kind: str
    peak: Optional[dict]
    matrices: List[dict]
    setup_s: float
    record: dict                       # the window's (generator.Driver.record)
    traced: Optional[dict]             # the traced step's, with --trace 1
    kernels_of: Dict[str, tuple]       # kernel wrapper -> its kernel names
    product: Dict[str, int]            # the product's wrappers -> launches a product


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str):
    """(benchmark, cell, configuration, traffic, limits) of a workload."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    (entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(SPBENCH, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(SPBENCH, "limits", f"{workload}.json"))
    return bench, cell, config, traffic, limits


def metrics_of(bench, workload: str, traced: bool):
    """The cell's end-to-end metrics, or with a trace its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = os.path.join(SPBENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "spbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _busy_ticks(cores):
    """{core: its non-idle clock ticks so far} from /proc/stat."""
    out = {}
    with open("/proc/stat") as f:
        for line in f:
            name, *ticks = line.split()
            if name.startswith("cpu") and name[3:].isdigit() and int(name[3:]) in cores:
                t = [int(v) for v in ticks]
                out[int(name[3:])] = sum(t) - t[3] - t[4]      # less idle, iowait
    return out


def idlest_core(cores, seconds=0.25):
    """The core of `cores` that ran least over `seconds` (the highest on a
    tie)."""
    before = _busy_ticks(cores)
    time.sleep(seconds)
    after = _busy_ticks(cores)
    return min(sorted(cores, reverse=True), key=lambda c: after[c] - before[c])


@contextlib.contextmanager
def one_core():
    """The calling thread on one core, the idlest as the block starts, while
    the block runs: the window's host path then does not migrate (the
    kernels' build, which runs before, keeps every core)."""
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {idlest_core(cores)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)


def banned_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             *, device=None, config=None, log=sys.stderr):
    """(result, checks) of one run.  device: the card unless given (the CPU
    tests pass 'cpu'); config: the configuration in place of the cell's
    file (the CPU tests pass a small one)."""
    bench, _, cfg, traffic, limits = cell_files(workload)
    cfg = config if config is not None else cfg
    device = torch.device(device or "cuda")
    t = time.perf_counter()
    stages = {"start_to_harness_s": t - t_start}
    torch.zeros(1, device=device)
    stages["device_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    importlib.import_module("cusp_autotuned_tpu_torch")
    stages["port_import_s"] = time.perf_counter() - t
    driver = generator.driver(cfg, traffic, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t_start
    # a full collection walks every object of torch and the port (~0.12 s
    # of host); frozen, the window's collections walk only its own
    gc.freeze()
    traced = None
    with one_core():
        if trace:
            captured, step = tracing.capture(lambda: driver.step(traffic["trace_units"]))
            traced = dict(step, trace=captured)
            if hasattr(driver, "host_us_per_call"):
                traced["host_us_per_call"] = driver.host_us_per_call()
        driver.window(seconds)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        peak_bytes = torch.cuda.max_memory_allocated(device)
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check(limits)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    run = Run(workload=workload, config=cfg, traffic=traffic, device_kind=kind,
              peak=counts.peaks(kind), matrices=driver.matrices, setup_s=setup_s,
              record=driver.record, traced=traced,
              kernels_of=generator.program.wrapper_kernels(), product=driver.product)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for key, value in {**stages, **driver.info}.items():
        print(f"spbench: {key} = {value}", file=log)
    print(f"spbench: setup_s = {setup_s}; window_s = {driver.record['window_s']}; "
          f"units in window = {driver.record['attempted']}", file=log)
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": peak_bytes if on_card else 0}
    result = {"correct": all(c.ok for c in checks),
              "attempted": driver.record["attempted"],
              "failed": driver.record["failed"], "metrics": metrics,
              "device": device_rec}
    captured = traced and traced["trace"]
    if captured:
        device_rec.update(busy_s=captured.busy_s, window_s=captured.window_s)
        result["breakdown"] = captured.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks
