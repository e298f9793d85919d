"""Strength-of-connection measures and the spectral radius of D^-1 A
(counterpart of cusp_autotuned_tpu/precond/aggregation/strength.py; parity:
cusp/precond/aggregation/system/detail/generic/symmetric_strength.h and
evolution_strength.h, and sa_level::rho_DinvA, smoothed_aggregation.h:45-68).
All of it is set-up work on the host in numpy and scipy, as in the JAX
package; the strength graphs come back as CSR containers on A's device."""

from __future__ import annotations

import numpy as np

from cusp_autotuned_tpu_torch.backend.reference import to_scipy
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.precond.aggregation.structured_rap import (
    band_eligible, band_shift, container_from_csr, get_band, offset_histogram,
)


def _lookup_on_pattern(V, keys, n, default=0.0):
    """Values of canonical CSR matrix V at the sorted linear pattern keys
    (i*n + j); positions V lacks get `default`."""
    rowv = np.repeat(np.arange(V.shape[0]), np.diff(V.indptr))
    keyv = rowv * n + V.indices
    pos = np.searchsorted(keyv, keys)
    pos_c = np.clip(pos, 0, max(keyv.size - 1, 0))
    if keyv.size == 0:
        return np.full(keys.size, default)
    hit = keyv[pos_c] == keys
    return np.where(hit, V.data[pos_c], default)


def symmetric_strength_of_connection(A, theta: float = 0.0):
    """Filtered pattern C: keep a_ij with |a_ij| >= theta*sqrt(|a_ii a_jj|)
    (diagonal always kept).  theta == 0 keeps everything."""
    if theta == 0.0:
        return convert(A, "csr")
    S = to_scipy(A).tocoo()
    diag_mask = S.row == S.col
    d = np.zeros(S.shape[0], np.float64)
    d[S.row[diag_mask]] = np.abs(S.data[diag_mask])
    keep = (np.abs(S.data) ** 2 >= (theta * theta) * d[S.row] * d[S.col]) \
        | (S.row == S.col)
    import scipy.sparse as sp
    C = sp.coo_matrix((S.data[keep], (S.row[keep], S.col[keep])),
                      shape=S.shape)
    return container_from_csr(C, A.dtype, A.device)


def _restricted_square(Z, chunk_rows: int = 65536):
    """(Z @ Z) restricted to Z's own sparsity pattern, computed in row
    chunks so the intermediate product never materializes whole (the
    reference's incomplete_inner_functor shortcut,
    evolution_strength.h:136-176)."""
    n = Z.shape[0]
    rowz = np.repeat(np.arange(n), np.diff(Z.indptr))
    out = np.empty_like(Z.data)
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        Zc = (Z[r0:r1] @ Z).tocsr()
        Zc.sum_duplicates()
        Zc.sort_indices()
        lo, hi = Z.indptr[r0], Z.indptr[r1]
        keys = (rowz[lo:hi] - r0) * n + Z.indices[lo:hi]
        out[lo:hi] = _lookup_on_pattern(Zc, keys, n)
    return out


def evolution_strength_of_connection(A, B=None, rho_DinvA: float | None = None,
                                     epsilon: float = 4.0):
    """Evolution (ODE) strength with the near-nullspace candidate B.

    Faithful rebuild of evolution_strength.h:180-399: one smoothing
    operator Z = I - (1/rho) D^-1 A at A's pattern, Z^2 restricted to the
    pattern (incomplete inner product), then each connection (i, j) scored
    by how well B[j] scaled by diag(Z^2)[i] approximates Z^2[i,j] — the
    approximation RATIO filters weak/negative-angle couplings, the
    approximation ERROR |1 - ratio| is the distance measure (smaller is
    stronger), followed by symmetrization, the per-row epsilon distance
    filter, a unit diagonal, and a final val + val^T symmetrization.
    B defaults to ones; a 2-D B uses its first column (the reference takes
    a single candidate vector)."""
    import scipy.sparse as sp
    S = to_scipy(A).tocsr().astype(np.float64)
    S.sum_duplicates()
    S.sort_indices()
    n = S.shape[0]
    nnz = S.nnz
    d = S.diagonal()
    d = np.where(d != 0, d, 1.0)
    if rho_DinvA is None:
        rho_DinvA = rho_Dinv_A(A)
    rho = max(float(rho_DinvA), 1e-30)

    rowi = np.repeat(np.arange(n), np.diff(S.indptr))
    coli = S.indices
    # Z = I - (1/rho) D^-1 A at A's pattern (Atilde_functor)
    zdata = np.where(rowi == coli, 1.0, 0.0) - (S.data / d[rowi]) / rho
    Z = sp.csr_matrix((zdata, S.indices.copy(), S.indptr.copy()), shape=S.shape)

    data = _restricted_square(Z)              # Z^2 on the pattern
    diag_mask = rowi == coli
    DAtilde = np.zeros(n)
    DAtilde[rowi[diag_mask]] = data[diag_mask]

    if B is None:
        Bv = np.ones(n)
    else:
        Bv = np.asarray(B, np.float64).reshape(n, -1)[:, 0]
    Bscale = np.where(Bv == 0, 1.0, Bv)       # Bmat_forscaling

    av = DAtilde[rowi] * Bscale[coli]         # row x column scaling
    angle = data * av
    neg_angle = angle < 0
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(data != 0, av / data, np.inf)
    weak_ratio = ratio < 1e-4
    err = np.abs(1.0 - ratio)
    vals = np.where(neg_angle | weak_ratio, 0.0, err)
    seps = np.sqrt(np.finfo(np.float64).eps)
    vals = np.where((vals < seps) & (vals != 0), 1e-4, vals)  # set_perfect

    pat_keys = rowi * n + coli

    def on_pattern(V):
        """Restrict a same-shape sparse matrix back onto S's pattern."""
        Vc = V.tocsr()
        Vc.sum_duplicates()
        Vc.sort_indices()
        return _lookup_on_pattern(Vc, pat_keys, n)

    Vm = sp.csr_matrix((vals, S.indices.copy(), S.indptr.copy()),
                       shape=S.shape)
    sym = 0.5 * (vals + on_pattern(Vm.T))

    if np.isfinite(epsilon):
        # per-row smallest nonzero measure; vals >= eps * smallest drop
        smallest = np.full(n, np.inf)
        nz = sym != 0
        np.minimum.at(smallest, rowi[nz], sym[nz])
        drop = sym >= epsilon * smallest[rowi]
        sym = np.where(drop & np.isfinite(smallest[rowi]), 0.0, sym)
    sym = np.where(diag_mask, 1.0, sym)
    Vs = sp.csr_matrix((sym, S.indices.copy(), S.indptr.copy()),
                       shape=S.shape)
    final = sym + on_pattern(Vs.T)

    keep = final != 0
    C = sp.coo_matrix((final[keep], (rowi[keep], coli[keep])), shape=S.shape)
    return container_from_csr(C, A.dtype, A.device)


def _ritz_radius(matvec, n, k, rng) -> float:
    """The largest |Ritz value| of a k-step Arnoldi factorization of the
    operator `matvec` from a seeded uniform start vector (parity:
    ritz_spectral_radius -> arnoldi(DinvA, H, 8) -> max |eig(H)|,
    spectral_radius.inl:211-224)."""
    q = rng.rand(n)
    nq = np.linalg.norm(q)
    if nq == 0:
        return 0.0
    Q = [q / nq]
    H = np.zeros((k + 1, k))
    m = k
    for j in range(k):
        v = matvec(Q[j])
        for i in range(j + 1):
            H[i, j] = Q[i] @ v
            v -= H[i, j] * Q[i]
        H[j + 1, j] = np.linalg.norm(v)
        if H[j + 1, j] <= 1e-12:
            m = j + 1
            break
        Q.append(v / H[j + 1, j])
    if m == 0:
        return 0.0
    return float(np.abs(np.linalg.eigvals(H[:m, :m])).max())


def rho_Dinv_A(A, k: int = 8, band=None) -> float:
    """Spectral radius of D^-1 A (reference: estimate_rho_Dinv_A =
    ritz_spectral_radius(Dinv_A, 8), eigen/detail/spectral_radius.inl:177).

    Where the JAX package holds A in band form (square, at most MAX_BAND
    diagonals), a k-step Arnoldi Ritz estimate, its matvec on the band
    (`band`, or get_band's) or, where get_band declines a sparse band, on
    the CSR form: both sum each row's terms in column order, so they give
    the same estimate.  Other matrices take host power iteration, as in the
    JAX package."""
    import scipy.sparse as sp
    rng = np.random.RandomState(0)
    S = to_scipy(A).tocsr().astype(np.float64)
    if band is None and band_eligible(S, offset_histogram(S)[0]):
        band = get_band(A)
        if band is None:
            S.sort_indices()
            d = S.diagonal()
            DinvA = sp.diags(1.0 / np.where(d != 0, d, 1.0)) @ S
            return _ritz_radius(lambda x: DinvA @ x, S.shape[0], k, rng)
    if band is not None:
        offs, data = band
        n = data[0].shape[0]
        d = data[offs.index(0)] if 0 in offs else np.zeros(n)
        dinv = 1.0 / np.where(d != 0, d, 1.0)
        scaled = [dinv * a for a in data]
        sh = np.empty(n)

        def matvec(x):
            y = np.zeros(n)
            for o, a in zip(offs, scaled):
                y += a * band_shift(x, o, out=sh)
            return y

        return _ritz_radius(matvec, n, k, rng)

    d = S.diagonal()
    d = np.where(d != 0, d, 1.0)
    DinvA = sp.diags(1.0 / d) @ S
    # nonsymmetric operator: power iteration on the host (small k)
    x = rng.rand(S.shape[0])
    lam = 1.0
    for _ in range(max(k, 15)):
        y = DinvA @ x
        lam = np.linalg.norm(y)
        if lam == 0:
            return 0.0
        x = y / lam
    return float(lam)
