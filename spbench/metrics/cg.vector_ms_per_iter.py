"""cg.vector_ms_per_iter (ms, device trace): device ms of every operation
of the traced solves that is not the SpMV's (readers.other_time), over the
iterations their monitors counted."""

from spbench import readers


def read(run):
    other = readers.other_time(run)
    its = run.traced and run.traced.get("iterations")
    return other * 1e3 / its if other is not None and its else None
