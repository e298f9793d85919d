"""Readings that set a cell's limits, and the faults that must fail them.

    python3 -m spbench.control --workload <name> --seeds 11,12,... --seconds <s> --plant <kind>

runs the cell once a seed in one process, as spbench.run does (the same
set-up, window and comparison; no trace), with the program as it is
(`--plant none`: the lower readings) or with something planted in its
place, and prints each run's compared numbers as one JSON line, then the
largest and smallest of each.  The benchmark's own runs never plant
anything.

Plants, each in the port's own entry points (solvers.cg.cg and
autotune.tuner.tuned_operator), so the harness above them runs unchanged:

  control    the reference in the program's place, computed in the
             precision next below the configuration's (float32 for
             float64, bfloat16 for float32): the upper readings
  unchanged  a step that returns its state unchanged: CG returns x0, a
             product returns its input
  half       half of the batch left out: the second half of x, of y's
             rows or of Y's columns is zero
  altered    one answer altered where it is produced: the first entry of
             x or y plus 1
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch

from spbench import harness, stencils
from spbench.reference import cg as ref_cg
from spbench.reference import stencil as ref_stencil

LOWER = {"float64": torch.float32, "float32": torch.bfloat16}
PLANTS = ("none", "control", "unchanged", "half", "altered")


def _spec_of(config, A):
    """The configuration's matrix that A was assembled from (by its
    entries and rows, which differ between a configuration's matrices)."""
    for spec in config["matrices"]:
        if (stencils.num_rows(spec["grid"]) == A.shape[0]
                and stencils.nnz_of(spec["grid"], stencils.points(spec)) == A.nnz):
            return spec
    raise KeyError("no matrix of the configuration matches")


def _broken(kind, y, x):
    """y as the fault `kind` leaves it (x is the input, for `unchanged`)."""
    if kind == "unchanged":
        return x.clone()
    y = y.clone()
    if kind == "half":
        if y.dim() == 2:
            y[:, y.shape[1] // 2:] = 0
        else:
            y[y.shape[0] // 2:] = 0
    elif kind == "altered":
        y.view(-1)[0] += 1
    return y


@contextlib.contextmanager
def plant(kind: str, config):
    """The port's entry points with `kind` planted, restored on exit."""
    if kind == "none":
        yield
        return
    cg_mod = importlib.import_module("cusp_autotuned_tpu_torch.solvers.cg")
    tuner = importlib.import_module("cusp_autotuned_tpu_torch.autotune.tuner")
    real_cg, real_tuned = cg_mod.cg, tuner.tuned_operator
    lower = LOWER[config["dtype"]]

    def cg(A, b, x0=None, monitor=None, M=None, mesh=None):
        if kind == "control":
            spec = _spec_of(config, A)
            x, its = ref_cg.cg(lambda v: ref_stencil.apply(spec, v, lower), b,
                               monitor.iteration_limit(), lower,
                               monitor.relative_tolerance())
            # the count its own stopping rule reached, in the lower precision
            monitor.residuals = [float("nan")] * (its + 1)
            return x.to(b.dtype), monitor
        x, monitor = real_cg(A, b, x0=x0, monitor=monitor, M=M, mesh=mesh)
        return _broken(kind, x, torch.zeros_like(b)), monitor

    def tuned_operator(A, x=None, **kw):
        if kind == "control":
            spec = _spec_of(config, A)
            return lambda v: ref_stencil.apply(spec, v, lower).to(v.dtype)
        op = real_tuned(A, x=x, **kw)
        return lambda v: _broken(kind, op(v), v)

    cg_mod.cg, tuner.tuned_operator = cg, tuned_operator
    try:
        yield
    finally:
        cg_mod.cg, tuner.tuned_operator = real_cg, real_tuned


def readings(workload, seeds, seconds, kind):
    """[(seed, {check: value}, correct)] of one run a seed on the card with
    `kind` planted."""
    _, _, cfg, _, _ = harness.cell_files(workload)
    out = []
    for seed in seeds:
        with plant(kind, cfg):
            result, checks = harness.run_cell(workload, seed, seconds, False,
                                              time.perf_counter())
        out.append((seed, {c.name: c.value for c in checks}, result["correct"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m spbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--plant", choices=PLANTS, default="none")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spbench.control: no CUDA card", file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds, args.plant)
    for seed, values, correct in rows:
        print(json.dumps({"workload": args.workload, "plant": args.plant, "seed": seed,
                          "correct": correct, **values}))
    names = rows[0][1].keys()
    print(json.dumps({"workload": args.workload, "plant": args.plant,
                      "max": {n: max(r[1][n] for r in rows) for n in names},
                      "min": {n: min(r[1][n] for r in rows) for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
