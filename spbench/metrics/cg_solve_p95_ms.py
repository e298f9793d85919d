"""cg_solve_p95_ms (ms, host clock): the 95th percentile of the times of
all the window's solves, each from the call to its result synchronised."""

from spbench import readers


def read(run):
    q = readers.unit_quantile(run, 95)
    return q * 1e3 if q is not None else None
