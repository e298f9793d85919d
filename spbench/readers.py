"""What the metric readers under spbench/metrics/ share: the window's rates
and the traced step's kernel times, device idle share and roofline
bounds.  Every function returns None where it finds nothing to read (no
trace, no card in the peak table, no kernel of the product's wrappers).

The product's wrappers are those that one product of the operator alone
moved in set-up (run.product, generator.product_launches); every other
kernel, counted by the port or not, is the work around the product."""

from __future__ import annotations

import statistics

from spbench import counts


def per_s(run, key: str):
    """The window's total of `key` over its seconds."""
    w = run.record.get("window_s")
    return run.record[key] / w if w else None


def unit_quantile(run, q: int):
    """The q-th percentile of the window's unit times (s), by Python's
    statistics.quantiles over all of them (inclusive method)."""
    times = run.record.get("unit_s") or []
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[q - 1]


def _trace(run):
    return run.traced and run.traced.get("trace")


def idle_pct(run):
    t = _trace(run)
    if not t or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def product_calls(run, launch_counts):
    """Products made, from the product's wrappers' launches: their sum over
    the launches one product makes, or None where no product was seen."""
    per_call = sum(run.product.values())
    made = sum(launch_counts.get(w, 0) for w in run.product)
    return made / per_call if per_call and made else None


def product_kernels(run):
    """The kernel names of the product's wrappers."""
    return {name for w in run.product for name in run.kernels_of.get(w, ())}


def product_time(run):
    """(device seconds, products) of the traced step's products: for each
    kernel of a product wrapper that launched, its mean over its recorded
    launches times the wrapper's launches (the profiler drops some
    records; a kernel with none recorded is taken as not launched).  None
    without a record."""
    t = _trace(run)
    if not t:
        return None
    by = t.by_name()
    total = 0.0
    for w in run.product:
        n = run.traced["counts"].get(w, 0)
        for name in run.kernels_of.get(w, ()):
            if n > 0 and name in by:
                seconds, recorded = by[name]
                total += seconds / recorded * n
    calls = product_calls(run, run.traced["counts"])
    return (total, calls) if total > 0 and calls else None


def recorded_share(run):
    """Recorded launches of the product wrappers' first kernels over their
    launches: the share of the step the profiler kept."""
    by = _trace(run).by_name()
    launched = recorded = 0
    for w in run.product:
        n, names = run.traced["counts"].get(w, 0), run.kernels_of.get(w, ())
        if n > 0 and names:
            launched += n
            recorded += by.get(names[0], (0.0, 0))[1]
    return recorded / launched if launched else None


def other_time(run):
    """Device seconds of every recorded operation that is not the
    product's, over the share of the step recorded."""
    t = _trace(run)
    if not t:
        return None
    share = recorded_share(run)
    if not share:
        return None
    names = product_kernels(run)
    return sum(s for name, (s, _) in t.by_name().items() if name not in names) / share


def product_bound_s(run, m) -> float:
    """The least time of one product of matrix m on this card."""
    return counts.bound_s(counts.multiply_flops(m["nnz"], m["k"]),
                          counts.multiply_bytes(m["nnz"], m["n_in"], m["n_out"],
                                                m["k"], m["value_size"]),
                          run.peak, m["dtype"])


def spmv_roofline_pct(run):
    """Share of the roofline of the traced step's products of the cell's one
    matrix: the least time of a product, times the products, over the
    product's kernels' device time (the other kernels, the solver's
    vector operations, are not the product's)."""
    timed = product_time(run)
    if timed is None or run.peak is None:
        return None
    (m,) = run.matrices
    return 100.0 * timed[1] * product_bound_s(run, m) / timed[0]


def multiply_roofline_pct(run):
    """Share of the roofline of the traced step's rounds, one product of
    every matrix a round: their least time over the device time of every
    operation the step ran (the product's kernels and any other)."""
    timed, other = product_time(run), other_time(run)
    if timed is None or other is None or run.peak is None:
        return None
    bound = run.traced["units"] * sum(product_bound_s(run, m) for m in run.matrices)
    return 100.0 * bound / (timed[0] + other)
