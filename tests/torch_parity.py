"""Helpers for the parity tests between the JAX package and its PyTorch port:
one input, built once from a numpy seed, handed to both packages."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch import interop

FIELDS = {"coo": ("row", "col", "val"), "csr": ("indptr", "col", "val", "row"),
          "dia": ("data",), "ell": ("col", "val"),
          "ellr": ("col", "val", "row_lengths")}


def port_of(A, device="cpu"):
    """The port's container holding the arrays of the JAX container A."""
    if A.format == "hyb":
        arrays = {f"{part}_{f}": np.asarray(getattr(getattr(A, part), f))
                  for part in ("ell", "coo") for f in FIELDS[part]}
    else:
        arrays = {f: np.asarray(getattr(A, f)) for f in FIELDS[A.format]}
    return interop.from_reference(A.format, arrays, A.shape, A.nnz,
                                  offsets=getattr(A, "offsets", None),
                                  device=device)


def banded(n_rows, n_cols, offsets, seed):
    """A scipy matrix with seeded random values on the given diagonals."""
    rng = np.random.RandomState(seed)
    return sp.diags([rng.uniform(0.5, 2.0, n_rows) for _ in offsets], offsets,
                    shape=(n_rows, n_cols)).tocoo()


def skewed_random(n, seed, max_len=64):
    """A scipy CSR matrix with seeded random columns and values whose row
    lengths follow a heavy-tailed (Pareto) law, capped at max_len."""
    rng = np.random.RandomState(seed)
    lengths = np.minimum(1 + rng.pareto(1.5, n).astype(np.int64), max_len)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    col = rng.randint(0, n, indptr[-1])
    val = rng.uniform(-1.0, 1.0, indptr[-1])
    S = sp.csr_matrix((val, col, indptr), shape=(n, n))
    S.sum_duplicates()
    return S


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a module's tests: they run many small ops,
    and where several test processes share the cores a pool of threads per
    process slows them many times over (a CG on eight mesh entries took 16
    s instead of 0.8 on a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
