"""Device idle share (%, device trace): the traced window's seconds in
which no operation ran on the card, over the window."""

from spbench import readers


def read(run):
    return readers.idle_pct(run)
