"""Matrix formats and conversion (reference: examples/MatrixFormats,
examples/MatrixAssembly)."""

import sys

import cusp_autotuned_tpu_torch as ct
from cusp_autotuned_tpu_torch.formats import coo_matrix
from cusp_autotuned_tpu_torch.ops.printing import print_matrix, spy


def main(device=None):
    # assemble a small matrix from triplets (duplicates are kept distinct
    # until converted)
    A = coo_matrix(row=[0, 0, 1, 2, 2, 3],
                   col=[0, 2, 1, 0, 3, 3],
                   val=[1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
                   shape=(4, 4), device=device)
    print_matrix(A)

    # all-pairs conversion; COO is the hub format
    entries = {}
    for fmt in ("csr", "dia", "ell", "ellr", "hyb"):
        B = ct.convert(A, fmt)
        entries[fmt] = B.num_entries
        print(f"{fmt}: {B.num_entries} entries, dtype {B.dtype}")

    # sparsity pattern in the terminal
    spy(A)
    return {"entries": entries}


if __name__ == "__main__":
    main(*sys.argv[1:])
