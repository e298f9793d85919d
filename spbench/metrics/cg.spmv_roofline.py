"""cg.spmv_roofline (%, device trace): the SpMV kernels' share of their
roofline in the traced sets (spbench/readers.py: spmv_roofline_pct)."""

from spbench import readers


def read(run):
    return readers.spmv_roofline_pct(run)
