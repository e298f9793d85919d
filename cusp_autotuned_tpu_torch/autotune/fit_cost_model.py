"""Fit the cost model's constants on the card in use.

    python -m cusp_autotuned_tpu_torch.autotune.fit_cost_model

It runs calibrate() (the stream triad, the gather and segment-sum probes
and the take probe), times every plan that the model prices (via_dia,
via_dense, and each rail's configuration: colsort2 at each of its tuning
axes' (vrow_planes, vrow_len)) on each matrix of `matrices()` as the tuner
times a walk (a CUDA graph's replay: device time), and fits the model's
free constants (FITTED) to those times by bounded least squares on the log
of model / measured (cost_model._price defines the price of a plan).  It
prints the shipped constants' model / measured over those plans, every
measurement beside the fitted prediction, the fitted model's
pick on each matrix against the fastest plan timed, and, last, the
constants as a DEVICE_MODEL update.
It needs one CUDA card; on a machine without one it exits at once.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from cusp_autotuned_tpu_torch.autotune import calibrate, cost_model
from cusp_autotuned_tpu_torch.autotune.tuner import Tuner
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, NotImplementedException,
)

# the constants the fit sets; calibrate() measures the card's rates
FITTED = ("launch_us", "lane_ns", "gather_scale", "serial_us", "serial_dia_us") \
    + tuple(f"eff_{k}" for k in ("dia", "dense") + cost_model.RAILS)
BOUNDS = {"launch_us": (0.0, 20.0), "lane_ns": (0.0, 1.0),
          "gather_scale": (0.0, 50.0), "serial_us": (0.0, 10.0),
          "serial_dia_us": (0.0, 10.0)}


def _csr(S, device):
    from cusp_autotuned_tpu_torch.precond.aggregation.structured_rap import (
        container_from_csr)
    return container_from_csr(S, torch.float32, device)


def matrices(device):
    """(name, CSR f32 matrix) pairs that span the features: stencils,
    random and skewed rows at a million rows, the scattered Williams
    entries, an AMG hierarchy's level operators, and a dense-ish block."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    from cusp_autotuned_tpu_torch.gallery.suite import SCATTERED
    from cusp_autotuned_tpu_torch.precond import smoothed_aggregation

    yield "poisson5pt 1000x1000", gallery.poisson5pt(1000, 1000, device=device)
    yield "poisson5pt 300x300", gallery.poisson5pt(300, 300, device=device)
    yield "poisson7pt 100^3", gallery.poisson7pt(100, 100, 100, device=device)
    # chip_smoke.py's skewed 1M-row matrix: Pareto row lengths of 1 to 4096
    n = 1_000_000
    rng = np.random.RandomState(2)
    lengths = np.minimum(1 + (4 * rng.pareto(1.5, n)).astype(np.int64), 4096)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.randint(0, n, indptr[-1]).astype(np.int32)
    val = rng.uniform(-1.0, 1.0, indptr[-1]).astype(np.float32)
    yield "skewed 1M", csr_matrix(indptr, col, val, (n, n), device=device)
    indptr = np.arange(n + 1, dtype=np.int64) * 8
    S = sp.csr_matrix((rng.uniform(-1, 1, 8 * n).astype(np.float32),
                       rng.randint(0, n, 8 * n), indptr), shape=(n, n))
    yield "uniform 1M x 8", _csr(S, device)
    for name, S in gallery.williams_suite(2.0, names=SCATTERED).items():
        yield name, _csr(S, device)
    for label, A in (("poisson5pt 1000x1000", gallery.poisson5pt(1000, 1000,
                                                                  device=device)),
                     ("poisson7pt 100^3", gallery.poisson7pt(100, 100, 100,
                                                             device=device))):
        M = smoothed_aggregation(A)
        for i, lvl in enumerate(M.levels):
            yield f"{label} level {i} P", lvl.P
            yield f"{label} level {i} R", lvl.R
            if i:
                yield f"{label} level {i} A", lvl.A
    S = sp.random(2000, 2000, density=0.3, random_state=5, format="csr",
                  dtype=np.float32)
    yield "random 2000x2000 at 0.3", _csr(S, device)


def plans(A, dev):
    """(config, cost_model._price arguments) of every plan the model prices
    on A: via_dia and via_dense where their guards pass, and each rail's
    (colsort2 once for each of its tuning axes' (vrow_planes, vrow_len))."""
    st = cost_model.pattern_stats(A)
    m, n, nnz = st["m"], st["n"], st["nnz"]
    v = A.dtype.itemsize
    vec = (m + n) * v
    out = []
    pred = cost_model.predict(A, device=dev)
    if "us" in pred["via_dia"]:
        out.append(({"impl": "via_dia"}, dict(
            kind="dia", kernels=1, bytes_=st["num_diagonals"] * m * v + vec,
            chain=st["num_diagonals"])))
    if "us" in pred["via_dense"]:
        out.append(({"impl": "via_dense"}, dict(kind="dense", kernels=1,
                                                bytes_=m * n * v + vec)))
    return out + cost_model.rail_plans(st, cost_model.features(A), v, dev)


def main():
    from scipy.optimize import least_squares
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    if not torch.cuda.is_available():
        sys.exit("fit_cost_model: torch sees no CUDA device")
    device = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    consts = calibrate.calibrate(device)
    print("calibrate:", json.dumps(consts), flush=True)
    dev = dict(cost_model.DEVICE_MODEL)
    tuner = Tuner()
    points = []                          # (matrix, config, price args, µs)
    for name, A in matrices(device):
        t0 = time.perf_counter()
        x = torch.from_numpy(np.random.RandomState(6).randn(A.num_cols)
                             .astype(np.float32)).to(device)
        got = []
        for cfg, args in plans(A, dev):
            try:
                fn = build_spmv(A, cfg)
            except (FormatConversionException, NotImplementedException):
                continue
            us = tuner._time_graph(fn, x) * 1e3
            del fn
            points.append((name, cfg, args, us))
            got.append(f"{_label(cfg)} {us:.2f}")
        st = cost_model.pattern_stats(A)
        print(f"{name}: {st['m']} x {st['n']}, nnz {st['nnz']}, "
              f"{st['num_diagonals']} diagonals, max row {st['max_degree']}; "
              f"device us " + ", ".join(got)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        del A, x
        torch.cuda.empty_cache()

    times = np.array([p[3] for p in points])

    def model(theta):
        d = {**dev, **dict(zip(FITTED, theta))}
        return np.array([cost_model._price(d, **p[2]) for p in points])

    lo = [BOUNDS.get(k, (0.01, 1.0))[0] for k in FITTED]
    hi = [BOUNDS.get(k, (0.01, 1.0))[1] for k in FITTED]
    start = np.clip([dev[k] for k in FITTED], lo, hi)
    _summary("shipped", model(start) / times)
    # relative error on a log scale: a 2x miss on a 3 µs plan weighs as much
    # as one on a 300 µs plan
    fit = least_squares(lambda th: np.log(model(th) / times), start,
                        bounds=(lo, hi))
    fitted = dict(zip(FITTED, fit.x))
    pred = model(fit.x)
    ratio = pred / times
    for (name, cfg, _, t), p in zip(points, pred):
        print(f"    {name:32s} {_label(cfg):16s} measured {t:9.2f} us, model "
              f"{p:9.2f} us ({p / t:.2f}x)")
    # the model's pick against the fastest plan timed, matrix by matrix
    for name in dict.fromkeys(p[0] for p in points):
        mine = [(p, t, cfg) for (nm, cfg, _, t), p in zip(points, pred) if nm == name]
        pick = min(mine, key=lambda r: r[0])
        best = min(mine, key=lambda r: r[1])
        print(f"    pick {name:32s} {_label(pick[2]):16s} {pick[1]:9.2f} us; fastest "
              f"{_label(best[2]):16s} {best[1]:9.2f} us ({pick[1] / best[1]:.2f}x)")
    _summary("fit", ratio)
    measured = {k: v for k, v in consts.items() if k in cost_model.DEVICE_MODEL}
    print("DEVICE_MODEL.update(" + json.dumps(
        {**measured, **{k: float(f"{v:.6g}") for k, v in fitted.items()}}) + ")")


def _summary(tag, ratio):
    """One line of model / measured over the plans: median, quartiles,
    extremes."""
    print(f"{tag}: {ratio.size} plans, model/measured median {np.median(ratio):.3f}, "
          f"quartiles {np.percentile(ratio, 25):.3f} {np.percentile(ratio, 75):.3f}, "
          f"extremes {ratio.min():.3f} {ratio.max():.3f}", flush=True)


def _label(cfg):
    return "/".join(str(v) for v in cfg.values())


if __name__ == "__main__":
    main()
