"""multiply_gflops (GFLOP/s, host clock): 2 nnz k of every product the
window completed, over the window."""

from spbench import readers


def read(run):
    rate = readers.per_s(run, "flops")
    return rate / 1e9 if rate is not None else None
