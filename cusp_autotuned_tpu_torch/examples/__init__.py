"""The JAX package's examples/01-09 in the port's idiom, one module each
under the JAX file's name.  Each has main(device=None), which runs on the
CUDA device unless given another (device="cpu" on a host without a GPU),
prints what the JAX example prints and returns those numbers as a dict.

    python -m cusp_autotuned_tpu_torch.examples.02_solve_poisson [cpu]

(load one by name with importlib.import_module: a module name may not
start with a digit in an import statement)."""

import importlib

NAMES = ("01_formats_and_convert", "02_solve_poisson", "03_amg_preconditioner",
         "04_autotuned_spmv", "05_graph_and_io", "06_multichip",
         "07_spmv_strategies", "08_large_operators",
         "09_matrix_free_and_assembly")


def load(name):
    """The example module of a name in NAMES."""
    return importlib.import_module(f"{__name__}.{name}")
