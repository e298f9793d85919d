"""Build the port's containers from the JAX package's.

A JAX container is passed as numpy arrays plus its static fields, so this
module imports neither JAX nor the JAX package: the parity tests use it to
run both packages on one matrix.  The arrays keep the reference's padded
layout, which the port's containers share.
"""

from __future__ import annotations

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.formats.base import index_tensor, value_tensor


def from_reference(fmt: str, arrays: dict, shape, nnz, offsets=None,
                   device="cpu"):
    """The port's `fmt` container ('coo', 'csr' or 'dia') holding `arrays`,
    the fields of the JAX container as numpy arrays (COO: row, col, val;
    CSR: indptr, col, val, row; DIA: data), with its shape, nnz and, for
    DIA, its offsets."""
    shape = (int(shape[0]), int(shape[1]))
    if fmt == "coo":
        return F.COO(row=index_tensor(arrays["row"], device),
                     col=index_tensor(arrays["col"], device),
                     val=value_tensor(arrays["val"], None, device),
                     shape=shape, nnz=int(nnz))
    if fmt == "csr":
        return F.CSR(indptr=index_tensor(arrays["indptr"], device),
                     col=index_tensor(arrays["col"], device),
                     val=value_tensor(arrays["val"], None, device),
                     row=index_tensor(arrays["row"], device),
                     shape=shape, nnz=int(nnz))
    if fmt == "dia":
        if offsets is None:
            raise ValueError("a DIA container needs its offsets")
        return F.DIA(data=value_tensor(arrays["data"], None, device),
                     offsets=tuple(int(o) for o in offsets),
                     shape=shape, nnz=int(nnz))
    raise ValueError(f"unknown format {fmt!r}")
