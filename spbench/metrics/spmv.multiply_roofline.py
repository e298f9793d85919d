"""Share of the roofline (%, device trace) of the traced rounds' products,
whatever kernels the tuner's picks run (spbench/readers.py:
multiply_roofline_pct)."""

from spbench import readers


def read(run):
    return readers.multiply_roofline_pct(run)
