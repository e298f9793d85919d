"""The benchmark's one seam to the program, cusp_autotuned_tpu_torch: its
modules, its containers, and the launch counters and kernel names its
kernel wrappers keep.  Nothing else under spbench/ imports the port, and
the reference imports none of it.  A driver calls the port through
`port(name).<function>`, looked up at call time, so a test can break the
timed path underneath the harness."""

from __future__ import annotations

import importlib

PACKAGE = "cusp_autotuned_tpu_torch"


def port(name: str):
    """The port's module `name` (e.g. "solvers.cg")."""
    return importlib.import_module(f"{PACKAGE}.{name}")


def matrix(fmt: str, arrays):
    """The port's container of a matrix the benchmark assembled
    (stencils.dia_arrays / csr_arrays), with no copy."""
    if fmt == "dia":
        data, offsets, shape, nnz = arrays
        return port("formats.dia").DIA(data=data, offsets=offsets, shape=shape, nnz=nnz)
    if fmt == "csr":
        indptr, col, val, row, shape, nnz = arrays
        return port("formats.csr").CSR(indptr=indptr, col=col, val=val, row=row,
                                       shape=shape, nnz=nnz)
    raise ValueError(f"no container for format {fmt!r}")


def read_counts():
    """{kernel wrapper: launches so far}."""
    return port("utils.device_time").read_counts()


def wrapper_kernels():
    """{kernel wrapper: the names of the kernels it launches}."""
    return dict(port("utils.device_time").WRAPPER_KERNELS)
