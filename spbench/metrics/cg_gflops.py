"""cg_gflops (GFLOP/s, host clock): HPCG's nominal operations of every solve
the window completed, at the iterations its stopping rule counted
(spbench/counts.py: cg_solve_flops), over the window."""

from spbench import readers


def read(run):
    rate = readers.per_s(run, "flops")
    return rate / 1e9 if rate is not None else None
