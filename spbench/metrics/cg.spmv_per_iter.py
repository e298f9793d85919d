"""cg.spmv_per_iter (launches/it, program counter): the SpMV products the
window's solves launched (the product's wrappers' launches over those of
one product) over the iterations their monitors counted; above 1 where a
solve launches iterations past its stop, as the masked tail of a block."""

from spbench import readers


def read(run):
    calls = readers.product_calls(run, run.record["counts"])
    its = run.record.get("iterations")
    return calls / its if calls and its else None
