"""Operations and bytes of the benchmark's work, from shapes alone, and the
table of the card's published peaks.

The byte count of a product does not depend on the format the program
chose: each stored value read once, x read once and y written once,

    bytes = (nnz + n_in * k + n_out * k) * value size,

so no index is counted (the least any format could move, as the port's
benchmarks/bytes_per_spmv.py counts each array once).  A product takes
2 nnz k operations.  HPCG's nominal operations of an unpreconditioned CG
solve (its own count, without the multigrid) are

    iterations * (2 nnz + 12 N) + (2 nnz + N)

for the iterations its stopping rule counted and the first residual,
whatever the program launches."""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def multiply_flops(nnz: int, k: int) -> int:
    return 2 * nnz * k


def multiply_bytes(nnz: int, n_in: int, n_out: int, k: int, value_size: int) -> int:
    return (nnz + (n_in + n_out) * k) * value_size


def cg_solve_flops(nnz: int, n: int, iterations: int) -> int:
    return iterations * (2 * nnz + 12 * n) + 2 * nnz + n


def peaks(kind: str):
    """The published peaks of a card by its name (torch.cuda.get_device_name),
    or None for a card the table lacks."""
    with open(PEAKS_FILE) as f:
        return json.load(f).get(kind)


def bound_s(flops: float, bytes_: float, peak, dtype_name: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak rate and the bytes over the HBM bandwidth."""
    return max(flops / peak["flops_per_s"][dtype_name],
               bytes_ / peak["hbm_bytes_per_s"])
