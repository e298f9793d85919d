"""Binary matrix serialization (counterpart of cusp_autotuned_tpu/io/binary.py;
parity target cusp/io/binary.h:68-139).

Two formats, as in the JAX package:
  - the native file is a NumPy .npz archive of the matrix's COO arrays
    plus its format and shape (the archive's members carry the time they
    were written, so two writes match member for member, not byte for
    byte);
  - `read_cusp_binary_*` / `write_cusp_binary_*` speak the reference's raw
    layout (cusp/io/detail/binary.inl:42-104: three size_t counts, then
    the COO row indices, column indices and values as little-endian
    arrays), for files written by the C++ library.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.io.matrix_market import as_scipy_coo, torch_dtype


def write_binary_file(A, path) -> None:
    S = as_scipy_coo(A)
    np.savez_compressed(path, fmt=np.bytes_(A.format.encode()),
                        shape=np.asarray(S.shape, np.int64),
                        row=S.row.astype(np.int32),
                        col=S.col.astype(np.int32),
                        val=S.data)


def read_binary_file(path, format: str | None = None, dtype=None, device=None):
    with np.load(path, allow_pickle=False) as z:
        fmt = bytes(z["fmt"]).decode() if format is None else format
        shape = tuple(int(s) for s in z["shape"])
        S = sp.coo_matrix((z["val"], (z["row"], z["col"])), shape=shape)
    return from_scipy(S, fmt, dtype=torch_dtype(dtype), device=device)


def write_binary_stream(A, stream) -> None:
    write_binary_file(A, stream)


def read_binary_stream(stream, format: str | None = None, dtype=None,
                       device=None):
    return read_binary_file(stream, format=format, dtype=dtype, device=device)


# -- the reference's raw layout ------------------------------------------------

def read_cusp_binary_stream(stream, format: str = "coo",
                            index_dtype=np.int32, value_dtype=np.float32,
                            dtype=None, device=None):
    """Read a matrix in the reference's raw binary layout
    (cusp/io/detail/binary.inl:42-78): three size_t (num_rows, num_cols,
    num_entries), then the row indices, column indices and values.
    index_dtype/value_dtype must match the types the file was written
    with (int/float by default)."""
    header = np.frombuffer(stream.read(3 * 8), dtype=np.uint64)
    if header.size != 3:
        raise ValueError("truncated cusp binary header")
    m, n, nnz = (int(v) for v in header)
    idt = np.dtype(index_dtype)
    vdt = np.dtype(value_dtype)
    row = np.frombuffer(stream.read(nnz * idt.itemsize), dtype=idt)
    col = np.frombuffer(stream.read(nnz * idt.itemsize), dtype=idt)
    val = np.frombuffer(stream.read(nnz * vdt.itemsize), dtype=vdt)
    if row.size != nnz or col.size != nnz or val.size != nnz:
        raise ValueError("truncated cusp binary payload")
    S = sp.coo_matrix((val, (row, col)), shape=(m, n))
    return from_scipy(S, format, dtype=torch_dtype(dtype), device=device)


def read_cusp_binary_file(path, format: str = "coo", index_dtype=np.int32,
                          value_dtype=np.float32, dtype=None, device=None):
    with open(path, "rb") as f:
        return read_cusp_binary_stream(f, format=format,
                                       index_dtype=index_dtype,
                                       value_dtype=value_dtype, dtype=dtype,
                                       device=device)


def write_cusp_binary_stream(A, stream, index_dtype=np.int32,
                             value_dtype=np.float32) -> None:
    """Write the reference's raw binary layout
    (cusp/io/detail/binary.inl:95-104)."""
    S = as_scipy_coo(A)
    stream.write(np.asarray([S.shape[0], S.shape[1], S.nnz],
                            np.uint64).tobytes())
    stream.write(S.row.astype(index_dtype).tobytes())
    stream.write(S.col.astype(index_dtype).tobytes())
    stream.write(S.data.astype(value_dtype).tobytes())


def write_cusp_binary_file(A, path, index_dtype=np.int32,
                           value_dtype=np.float32) -> None:
    with open(path, "wb") as f:
        write_cusp_binary_stream(A, f, index_dtype=index_dtype,
                                 value_dtype=value_dtype)
