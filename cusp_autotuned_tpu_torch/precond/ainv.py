"""Approximate-inverse (AINV) preconditioners (counterpart of
cusp_autotuned_tpu/precond/ainv.py).

Parity: cusp/precond/ainv.h:52-163 and detail/ainv.inl: Bridson's
right-looking outer-product (bi)conjugation with the same dropping knobs:
drop_tolerance (absolute), nonzero_per_row (keep the largest) and
lin_dropping (the cap is lin_param plus the nnz of A's row).

The factorisation is sequential and runs on the host at set-up, as the
reference's does, in the port's native code (native/ainv.cpp, a copy of the
repository's `native/ainv.cpp`), which raises where it cannot be built.
The Python loops below are the plain versions the tests hold it against.
The factors land on A's device in A's dtype, and AINVOperator plans Z and
W^T once (operators.solve_operator): on the card M r is two CSR-kernel
SpMVs and a scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch.backend.reference import from_scipy, to_scipy
from cusp_autotuned_tpu_torch.ops.multiply import multiply


@dataclasses.dataclass(frozen=True)
class AINVOperator:
    """M r = Z D^-1 W^T r (W is Z for the SPD variants, D is I when
    scaled).  z and wt are the factor containers; z_op and wt_op the
    operators a product runs."""
    z: Any
    wt: Any
    diag_inv: torch.Tensor
    z_op: Any
    wt_op: Any
    shape: Tuple[int, int] = (0, 0)

    format = "ainv_preconditioner"

    def __call__(self, r):
        return multiply(self.z_op, self.diag_inv * multiply(self.wt_op, r),
                        use_autotuning=False)


def _container(rows, cols, vals, A):
    n = A.num_rows
    return from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=(n, n)), "csr",
                      dtype=A.dtype, device=A.device)


def ainv_operator(A, z_triplets, w_triplets, dinv) -> AINVOperator:
    """The operator of factors given as (row, col, val) host triplets and
    D^-1 as a host vector, on A's device in A's dtype."""
    from cusp_autotuned_tpu_torch.operators import solve_operator
    from cusp_autotuned_tpu_torch.ops.transpose import transpose
    Z = _container(*z_triplets, A)
    W = Z if w_triplets is z_triplets else _container(*w_triplets, A)
    Wt = transpose(W)
    dinv = torch.from_numpy(np.asarray(dinv)).to(device=A.device, dtype=A.dtype)
    return AINVOperator(z=Z, wt=Wt, diag_inv=dinv, z_op=solve_operator(Z),
                        wt_op=solve_operator(Wt), shape=tuple(A.shape))


def _inverse(diag):
    return np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1), 0)


def _spd(A, drop_tolerance, nonzero_per_row, lin_dropping, lin_param, scaled):
    from cusp_autotuned_tpu_torch import native
    S = to_scipy(A).tocsr()
    *w, diag = native.ainv_spd(S.indptr, S.indices, S.data.astype(np.float64),
                               drop_tolerance, nonzero_per_row, lin_dropping,
                               lin_param, scaled)
    w = tuple(w)
    return ainv_operator(A, w, w, np.ones_like(diag) if scaled else _inverse(diag))


def scaled_bridson_ainv(A, drop_tolerance: float = 0.1,
                        nonzero_per_row: int = -1, lin_dropping: bool = False,
                        lin_param: int = 1) -> AINVOperator:
    """SPD AINV with the columns scaled by 1/sqrt(p): M = W W^T
    (ainv.h:52, the scaled constructor of detail/ainv.inl)."""
    return _spd(A, drop_tolerance, nonzero_per_row, lin_dropping, lin_param, True)


def bridson_ainv(A, drop_tolerance: float = 0.1, nonzero_per_row: int = -1,
                 lin_dropping: bool = False, lin_param: int = 1) -> AINVOperator:
    """SPD AINV, unscaled: M = W D^-1 W^T (ainv.h:99)."""
    return _spd(A, drop_tolerance, nonzero_per_row, lin_dropping, lin_param, False)


def nonsym_bridson_ainv(A, drop_tolerance: float = 0.1,
                        nonzero_per_row: int = -1, lin_dropping: bool = False,
                        lin_param: int = 1) -> AINVOperator:
    """Non-symmetric biconjugation: M = Z D^-1 W^T with W^T A Z = D
    (ainv.h:143); without dropping M = A^-1.  The JAX package updates Z
    with W's multipliers and W with Z's, so its M is not A^-1 even then:
    the port follows the algorithm, which the scipy oracle arbitrates."""
    from cusp_autotuned_tpu_torch import native
    S = to_scipy(A).tocsr()
    St = S.T.tocsr()
    z, w, diag = native.ainv_nonsym(
        S.indptr, S.indices, S.data.astype(np.float64), St.indptr, St.indices,
        St.data.astype(np.float64), drop_tolerance, nonzero_per_row,
        lin_dropping, lin_param)
    return ainv_operator(A, z, w, 1.0 / diag)


# -- the plain versions (the JAX package's Python factorisations) --------------

def _drop(vec: dict, drop_tolerance: float, row_count: int, keep: int):
    """In place: remove |v| < tol (except `keep`), then cap the size."""
    if drop_tolerance > 0:
        for k in [k for k, v in vec.items()
                  if k != keep and abs(v) < drop_tolerance]:
            del vec[k]
    if row_count > 0 and len(vec) > row_count:
        items = sorted(vec.items(), key=lambda kv: -abs(kv[1]))
        kept = dict(items[:row_count])
        if keep in vec:
            kept[keep] = vec[keep]
        vec.clear()
        vec.update(kept)


def _axpy_drop(target: dict, alpha: float, source: dict,
               drop_tolerance: float, row_count: int, keep: int):
    for k, v in source.items():
        target[k] = target.get(k, 0.0) + alpha * v
    _drop(target, drop_tolerance, row_count, keep)


def _row_cap(nonzero_per_row, lin_dropping, lin_param, a_row_nnz):
    if lin_dropping:
        return max(1, lin_param + a_row_nnz)
    return nonzero_per_row


def _sparse_matvec(rows, vec: dict) -> dict:
    """B^T vec for B given by its CSR rows (the rows of B combined); pass
    the rows of A^T to get A vec."""
    out: dict = {}
    indptr, col, val = rows
    for j, w in vec.items():
        for p in range(indptr[j], indptr[j + 1]):
            out[col[p]] = out.get(col[p], 0.0) + val[p] * w
    return out


def _triplets(factors):
    """factors[j] = sparse column j -> (row, col, val) of the matrix."""
    rows = [i for vec in factors for i in vec]
    cols = [j for j, vec in enumerate(factors) for _ in vec]
    vals = [v for vec in factors for v in vec.values()]
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(vals, np.float64))


def ainv_spd_host(indptr, col, val, drop_tolerance, nonzero_per_row,
                  lin_dropping, lin_param, scaled):
    """native.ainv_spd in Python: (w_row, w_col, w_val, diag), diag the
    pivots p (ones when scaled)."""
    n = len(indptr) - 1
    a_nnz_row = np.diff(indptr)
    w = [{j: 1.0} for j in range(n)]
    diag = np.ones(n, np.float64)
    for j in range(n):
        u = _sparse_matvec((indptr, col, val), w[j])
        p = sum(w[j].get(k, 0.0) * v for k, v in u.items())
        if scaled:
            scale = 1.0 / math.sqrt(abs(p)) if p != 0 else 1.0
            u = {k: v * scale for k, v in u.items()}
            w[j] = {k: v * scale for k, v in w[j].items()}
        else:
            diag[j] = p
        for i, ui in u.items():
            if i <= j or ui == 0:
                continue
            cap = _row_cap(nonzero_per_row, lin_dropping, lin_param,
                           int(a_nnz_row[i]))
            _axpy_drop(w[i], -ui / (1.0 if scaled else p), w[j],
                       drop_tolerance, cap, keep=i)
    return (*_triplets(w), diag)


def ainv_nonsym_host(indptr, col, val, at_indptr, at_col, at_val,
                     drop_tolerance, nonzero_per_row, lin_dropping, lin_param):
    """native.ainv_nonsym in Python: ((z triplets), (w triplets), diag)."""
    n = len(indptr) - 1
    a_nnz_row = np.diff(indptr)
    zf = [{j: 1.0} for j in range(n)]
    wf = [{j: 1.0} for j in range(n)]
    diag = np.zeros(n, np.float64)
    for j in range(n):
        u = _sparse_matvec((at_indptr, at_col, at_val), zf[j])     # u = A z_j
        l = _sparse_matvec((indptr, col, val), wf[j])              # l = A^T w_j
        p = sum(wf[j].get(k, 0.0) * v for k, v in u.items())
        diag[j] = p if p != 0 else 1.0
        # z_i takes (A^T w_j)_i and w_i takes (A z_j)_i (native/ainv.cpp says
        # why; the JAX package swaps them)
        for factors, hits in ((zf, l), (wf, u)):
            for i, hi in hits.items():
                if i <= j or hi == 0:
                    continue
                cap = _row_cap(nonzero_per_row, lin_dropping, lin_param,
                               int(a_nnz_row[i]))
                _axpy_drop(factors[i], -hi / diag[j], factors[j],
                           drop_tolerance, cap, keep=i)
    return _triplets(zf), _triplets(wf), diag
