"""Offline tuning CLI: `python -m cusp_autotuned_tpu_torch.autotune A.mtx`
(counterpart of cusp_autotuned_tpu/autotune/__main__.py).

The front door the reference exposes through its profiling program
(main.cu): load a matrix, run the exhaustive offline search with oracle
validation (backend/reference.reference_spmv), report every
configuration's status and time and the winner, and leave the results in
the tuner's cache (CUSP_TORCH_TUNING_CACHE, where set) so that later
`multiply` and solver runs dispatch the tuned kernel at once.  Progress
streams to stderr, one line a configuration (Tuner.log_fn); the table or
the JSON line goes to stdout.

It runs on the CUDA device unless `--device` names another (`--device
cpu` on a host without a GPU; without it such a host raises).  The JAX
CLI's enable_compile_cache() has no counterpart: it turns on XLA's
persistent executable cache, and the port's kernels are built once by
nvcc into the package's git-ignored `_build/` directory, where every
later process loads them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def load_matrix(spec: str, fmt: str = "csr", dtype="float32", device=None):
    """The matrix a CLI argument names: a .mtx or .bin path,
    poisson5pt:N[xM], or suite:<Williams name>[:scale] (gallery.suite's
    structure-matched stand-in), as a `fmt` container on `device`.  A .bin
    file keeps its own dtype, as in the JAX CLI."""
    from cusp_autotuned_tpu_torch import gallery, io
    from cusp_autotuned_tpu_torch.io.matrix_market import torch_dtype
    from cusp_autotuned_tpu_torch.utils.config import resolve_device
    device = resolve_device(device)
    np_dtype = np.dtype(dtype)
    if spec.startswith("poisson5pt:"):
        nx, _, ny = spec.split(":", 1)[1].partition("x")
        return gallery.poisson5pt(int(nx), int(ny or nx), format=fmt,
                                  dtype=torch_dtype(np_dtype), device=device)
    if spec.startswith("suite:"):
        from cusp_autotuned_tpu_torch.backend.reference import from_scipy
        from cusp_autotuned_tpu_torch.gallery.suite import williams_suite
        parts = spec.split(":")
        name, scale = parts[1], float(parts[2]) if len(parts) > 2 else 1.0

        def norm(t):
            return t.lower().replace("/", "").replace(" ", "")
        suite = williams_suite(scale)
        match = [S for n, S in suite.items() if norm(n) == norm(name)]
        if not match:
            raise ValueError(f"unknown suite matrix {name!r}; one of {list(suite)}")
        S, = match
        return from_scipy(S.tocoo().astype(np_dtype), fmt, device=device)
    if spec.endswith(".bin"):
        return io.read_binary_file(spec, format=fmt, device=device)
    return io.read_matrix_market_file(spec, format=fmt, dtype=np_dtype,
                                      device=device)


def main(argv=None) -> int:
    from cusp_autotuned_tpu_torch.autotune.tuner import CHANNELS

    ap = argparse.ArgumentParser(
        prog="python -m cusp_autotuned_tpu_torch.autotune",
        description="Offline-tune SpMV for a matrix (KTT tune() analogue)")
    ap.add_argument("matrix", help=".mtx/.bin path, poisson5pt:N[xM], "
                    "or suite:<Williams name>[:scale] (structure-matched "
                    "stand-in, e.g. suite:Economics)")
    ap.add_argument("--format", default="csr",
                    help="container format to tune (default csr)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--choose-format", action="store_true",
                    help="also search across formats and report the best")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of the table")
    ap.add_argument("--budget", type=float, default=None, metavar="SECONDS",
                    help="stop the walk after this much wall time "
                    "(TuningDuration stop condition); implies the "
                    "model-guided order so the likely winners are "
                    "measured before the long tail")
    ap.add_argument("--order", choices=["deterministic", "model", "random"],
                    default=None,
                    help="walk order (default: model when --budget is "
                    "set, else deterministic)")
    ap.add_argument("--channel", choices=CHANNELS, default="auto",
                    help="timing channel: CUDA events around a CUDA graph's "
                    "replay on the card ('auto' takes the host clock for "
                    "a CPU device; 'cuda_events' raises there)")
    ap.add_argument("--device", default=None,
                    help="torch device to tune on (default: the CUDA device)")
    args = ap.parse_args(argv)

    from cusp_autotuned_tpu_torch import autotune
    from cusp_autotuned_tpu_torch.autotune.space import (
        config_key, configurations_for)
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv

    # a full walk can run for minutes: always stream per-configuration
    # progress to stderr (the table or JSON stays on stdout)
    tuner = autotune.get_tuner()
    if tuner.log_fn is None:
        tuner.log_fn = lambda m: print(m, file=sys.stderr, flush=True)
    tuner.timing_channel = args.channel

    try:
        A = load_matrix(args.matrix, args.format, args.dtype, args.device)
    except ValueError as e:
        ap.error(str(e))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(A.num_cols).astype(args.dtype)).to(A.device)

    searcher = stop = None
    order = args.order or ("model" if args.budget else None)
    if order == "model":
        searcher = autotune.ModelGuidedSearcher(A)
    elif order == "random":
        searcher = autotune.RandomSearcher()
    if args.budget:
        stop = autotune.TuningDuration(args.budget)

    results = autotune.tune(A, x, reference_computation=reference_spmv,
                            searcher=searcher, stop_condition=stop)
    best = tuner.best_configuration(A, x)
    # the JAX rows' device_us holds a second timing channel, which the
    # port's tuner does not have (autotune/result.py)
    rows = [{"config": r.configuration, "status": r.status.value,
             "time_ms": (round(r.duration_ms, 3)
                         if np.isfinite(r.duration_ms) else None)}
            for r in results]
    out = {"matrix": args.matrix, "format": A.format,
           "shape": [A.num_rows, A.num_cols], "nnz": int(A.nnz),
           "configs": len(rows),
           "ok": sum(r["status"] == "Ok" for r in rows),
           "channel": tuner.channel(x),
           "best": best,
           "results": rows}
    if args.budget:
        out["budget_s"] = args.budget
    if order:
        out["order"] = order
    # self-describing truncation (no silent caps): when a budget stopped
    # the walk early, record how much of the space went unwalked and what
    # the model predicts for the best unwalked configuration relative to
    # the walked region, so that a reader of the output alone can tell
    # whether the unwalked tail plausibly hides a winner
    space = configurations_for(A)
    out["space_size"] = len(space)
    if len(rows) < len(space):
        walked = {config_key(r.configuration) for r in results}
        unwalked = [c for c in space if config_key(c) not in walked]
        note = {"unwalked": len(unwalked)}
        from cusp_autotuned_tpu_torch.autotune.cost_model import model_order_key
        key = model_order_key(A)
        ok = [key(r.configuration) for r in results if r.is_valid()]
        if ok:                  # the JAX CLI's guard: an estimate needs an Ok
            best_un = min(unwalked, key=key)
            note.update(
                model_best_unwalked=best_un,
                model_best_unwalked_us=round(key(best_un), 1),
                model_best_walked_us=round(min(ok), 1),
                unwalked_predicted_worse=bool(key(best_un) >= min(ok)))
        out["coverage"] = note
    if args.choose_format:
        B, cfg = autotune.choose_format(A, x)
        out["best_format"] = B.format
        out["best_format_config"] = cfg

    if args.json:
        print(json.dumps(out))
    else:
        for r in rows:
            t = f"{r['time_ms']:.3f} ms" if r["time_ms"] is not None else "-"
            print(f"{r['status']:24s} {t:>12s}  {r['config']}")
        print(f"\n{out['ok']}/{out['configs']} Ok; best: {best}")
        if args.choose_format:
            print(f"best format: {out['best_format']} "
                  f"({out['best_format_config']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
