"""Per-format useful-byte models for one SpMV (counterpart of the JAX
repository's benchmarks/bytes_per_spmv.py; parity: the reference's
performance/spmv/bytes_per_spmv.h): each array read once, x read once and y
written once, the roofline-minimum model.  The counts are of the port's own
arrays.

Where the port's layout is the JAX package's, the counts are equal:

  COO, CSR  the port pads row, col and val to the same lane-aligned
            length, max(128, round_up(nnz, 128)), that the JAX containers
            call nnz_padded (the port has no such property: it reads
            col.shape[0]);
  DIA       (ndiag, rows_padded) data with the same padding; the offsets
            are a handful of host ints in both and count no traffic.

Where it is not, the count differs by the padding the JAX package adds:

  ELL, ELLR the port keeps (width, m) slots where the JAX package keeps
            (width, rows_padded), and ELLR's row_lengths is (m,) where it
            is (rows_padded,): the JAX count is larger by
            width (rows_padded - m) (4 + vsize) bytes, plus
            (rows_padded - m) 4 for ELLR;
  HYB       its ELL part's difference (its COO part matches).
"""

from __future__ import annotations

from cusp_autotuned_tpu_torch import formats as F

ISIZE = 4                          # int32 indices


def bytes_per_spmv(A) -> int:
    vsize = A.dtype.itemsize
    m, n = A.shape
    vectors = (n + m) * vsize
    if isinstance(A, F.COO):
        return A.col.shape[0] * (2 * ISIZE + vsize) + vectors
    if isinstance(A, F.CSR):
        return (m + 1) * ISIZE + A.col.shape[0] * (ISIZE + vsize) + vectors
    if isinstance(A, F.DIA):
        return A.data.numel() * vsize + vectors
    if isinstance(A, F.ELLR):
        return (A.col.numel() * (ISIZE + vsize) + A.row_lengths.numel() * ISIZE
                + vectors)
    if isinstance(A, F.ELL):
        return A.col.numel() * (ISIZE + vsize) + vectors
    if isinstance(A, F.HYB):
        # x read and y written once for the two parts together
        return bytes_per_spmv(A.ell) + bytes_per_spmv(A.coo) - vectors
    raise TypeError(f"no byte model for {type(A)}")


def flops_per_spmv(A) -> int:
    return 2 * A.nnz
