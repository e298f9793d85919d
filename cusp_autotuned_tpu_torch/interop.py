"""Build the port's containers from the JAX package's.

A JAX container is passed as numpy arrays plus its static fields, so this
module imports neither JAX nor the JAX package: the parity tests use it to
run both packages on one matrix.  COO, CSR and DIA arrays keep the
reference's padded layout, which the port's containers share; ELL slot
arrays are cut from the reference's 128-multiple row count to the matrix's
rows; an Array2d keeps the reference's pitch.
"""

from __future__ import annotations

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.formats.base import index_tensor, value_tensor
from cusp_autotuned_tpu_torch.utils.config import resolve_device


def from_reference(fmt: str, arrays: dict, shape, nnz=None, offsets=None,
                   device=None, orientation="c"):
    """The port's `fmt` container holding `arrays`, the fields of the JAX
    container as numpy arrays (COO: row, col, val; CSR: indptr, col, val,
    row; DIA: data; ELL: col, val; ELLR: col, val, row_lengths; HYB: the
    ELL part's as ell_col, ell_val and the COO part's as coo_row, coo_col,
    coo_val; array2d: values, the pitched buffer, with its orientation),
    with its shape, nnz and, for DIA, its offsets.  It lands on `device`,
    by default the CUDA device."""
    device = resolve_device(device)
    shape = (int(shape[0]), int(shape[1]))
    if fmt == "array2d":
        return F.make_array2d_view(value_tensor(arrays["values"], None, device),
                                   shape[0], shape[1], orientation)
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
    if fmt == "ell":
        return F.ell_matrix(arrays["col"], arrays["val"], shape, device=device)
    if fmt == "ellr":
        return F.ellr_matrix(arrays["col"], arrays["val"], shape,
                             row_lengths=arrays["row_lengths"], device=device)
    if fmt == "hyb":
        ell = F.ell_matrix(arrays["ell_col"], arrays["ell_val"], shape,
                           device=device)
        coo = from_reference("coo", {k: arrays[f"coo_{k}"]
                                     for k in ("row", "col", "val")},
                             shape, int(nnz) - ell.nnz, device=device)
        return F.hyb_matrix(ell, coo)
    raise ValueError(f"unknown format {fmt!r}")
