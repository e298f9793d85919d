"""Closed-form smoothed prolongator and Galerkin RAP on structured levels
(counterpart of cusp_autotuned_tpu/precond/aggregation/structured_rap.py).

On a raster-grid level (detect_grid) with block aggregation
(structured_aggregate) the whole SA level build is stencil algebra:

  A  is banded on the (ny, nx) raster (offsets o = dy*nx + dx, small
     |dy|, |dx|): a stencil with per-row coefficients;
  T  is the Kronecker block-aggregation map with one weight per fine row
     (fit_candidates on a 1-nnz-per-row pattern);
  M := I - s D^-1 A  is a stencil (A's offsets and 0);
  P  = M T, R = P^T, and A_c = R A P = T^T (M^T A M) T.

So A_c is a stencil convolution: K := M^T A M is banded, and folding K
through T on both sides regroups fine cells into coarse raster cells, in
O(k^2 n) host flops with no generic sparse product; the coarse operator is
banded on the coarse raster, so the closed form recurses.  The generic scipy
triple product (smooth.galerkin_product) is the oracle the tests hold it to.

Band convention (by row): data[k][i] = A[i, i + offsets[k]], zero where
i + offset is out of range.

The JAX package caches a level's band on its container for every pattern
of up to MAX_BAND diagonals (one dense f64 array a diagonal, ~0.8 GB at 1M
rows and 100 diagonals).  Here get_band builds a band only when it holds at
most the DIA fill guard's share of A's entries, caches nothing, and the
set-up passes one level's band to the stages that read it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

import scipy.sparse as sp

MAX_BAND = 128   # bail out of band representations past this many offsets


def offset_histogram(S: sp.spmatrix):
    """(offsets, counts, off-per-entry) of col - row without a sort: one
    bincount over the shifted offsets."""
    C = S.tocoo()
    n, m = C.shape
    off = C.col.astype(np.int64) - C.row.astype(np.int64)
    if C.nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), off
    hist = np.bincount(off + (n - 1), minlength=n + m - 1)
    nz = np.flatnonzero(hist)
    return nz - (n - 1), hist[nz], off


def csr_to_band(S: sp.csr_matrix, offsets=None, off=None):
    """(offsets, [band arrays]) with band[k][i] = S[i, i + offsets[k]]
    (by-row).  Pass precomputed (offsets, off-per-entry) to skip the
    histogram."""
    C = S.tocoo()
    n = C.shape[0]
    if off is None:
        off = C.col.astype(np.int64) - C.row.astype(np.int64)
    if offsets is None:
        offsets, _, _ = offset_histogram(S)
    data = np.zeros((len(offsets), n), np.float64)
    idx = np.searchsorted(offsets, off)
    data[idx, C.row] = C.data
    return [int(o) for o in offsets], [data[k] for k in range(len(offsets))]


def band_eligible(S: sp.spmatrix, offsets) -> bool:
    """Whether the JAX package would hold S in band form: square, with
    1..MAX_BAND distinct diagonals."""
    return S.shape[0] == S.shape[1] and 0 < len(offsets) <= MAX_BAND


def get_band(A):
    """By-row band form of A, or None: when the JAX package has no band
    (band_eligible), or when the band would hold more than MAX_FILL_RATIO
    times A's entries and more than FILL_THRESHOLD values (the DIA fill
    guard of ops.convert).  Nothing is cached on A."""
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    from cusp_autotuned_tpu_torch.ops.convert import FILL_THRESHOLD, MAX_FILL_RATIO
    S = to_scipy(A).tocsr()
    offsets, _, off = offset_histogram(S)
    size = offsets.size * S.shape[0]
    if not band_eligible(S, offsets) or (size > MAX_FILL_RATIO * max(S.nnz, 1)
                                         and size > FILL_THRESHOLD):
        return None
    return csr_to_band(S, offsets, off)


def band_shift(a: np.ndarray, o: int, out: np.ndarray = None) -> np.ndarray:
    """out[i] = a[i + o] (zero fill)."""
    n = a.shape[-1]
    if out is None:
        out = np.zeros_like(a)
    else:
        out[...] = 0
    if o >= 0:
        if o < n:
            out[..., : n - o] = a[..., o:]
    else:
        if -o < n:
            out[..., -o:] = a[..., : n + o]
    return out


def band_transpose(offsets: List[int], data: List[np.ndarray]):
    """(M^T)[i, i+o] = M[i+o, i] = data[-o][i+o]."""
    order = sorted(range(len(offsets)), key=lambda k: -offsets[k])
    t_off = [-offsets[k] for k in order]
    t_data = [band_shift(data[k], -offsets[k]) for k in order]
    return t_off, t_data


def band_mul(offA: List[int], dataA: List[np.ndarray],
             offB: List[int], dataB: List[np.ndarray]):
    """C = A @ B in by-row band form:
    C[i, i+oa+ob] += A[i, i+oa] * B[i+oa, i+oa+ob]
                   = dataA[oa][i] * dataB[ob][i+oa].
    In-place accumulation with one reused scratch buffer — the hot host
    loop of the closed-form RAP."""
    n = dataA[0].shape[0]
    dt = np.result_type(dataA[0].dtype, dataB[0].dtype)
    acc: Dict[int, np.ndarray] = {}
    shifted = np.empty(n, dt)
    scratch = np.empty(n, dt)
    for oa, a in zip(offA, dataA):
        for ob, b in zip(offB, dataB):
            band_shift(b, oa, out=shifted)
            np.multiply(a, shifted, out=scratch)
            o = oa + ob
            cur = acc.get(o)
            if cur is None:
                acc[o] = scratch.copy()
            else:
                np.add(cur, scratch, out=cur)
    offs = sorted(acc)
    return offs, [acc[o] for o in offs]


def band_to_scipy(offsets: List[int], data: List[np.ndarray],
                  shape) -> sp.csr_matrix:
    """By-row band -> scipy CSR.  scipy's dia_matrix indexes data by
    COLUMN (data[k][j] = A[j - o, j]), so shift each band by its offset."""
    n, m = shape
    sdata = np.stack([band_shift(d, -o) for o, d in zip(offsets, data)])
    if sdata.shape[1] < m:
        sdata = np.pad(sdata, ((0, 0), (0, m - sdata.shape[1])))
    D = sp.dia_matrix((sdata[:, :m], np.asarray(offsets)), shape=shape)
    return D.tocsr()


def container_from_csr(S: sp.spmatrix, dtype, device):
    """A CSR container of torch `dtype` on `device` straight from a scipy
    matrix in canonical CSR form (no COO round trip, no nnz-sized sort)."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    S = S.tocsr()
    S.sort_indices()
    return csr_matrix(S.indptr, S.indices, S.data, S.shape, dtype=dtype,
                      device=device)


def _block_divmod(n_fine: int, p: int) -> Tuple[int, np.ndarray, np.ndarray]:
    nb = -(-n_fine // p)
    idx = np.arange(n_fine)
    return nb, idx // p, idx % p


def structured_smooth_rap(Ssp: sp.csr_matrix, w: np.ndarray,
                          grid: Tuple[int, int], block: Tuple[int, int],
                          scale: float, band=None):
    """Closed-form (P, A_coarse) for one structured SA level.

    Ssp: the level operator (host CSR, raster (ny, nx) row-major order);
    w: fine-row tentative weights (T[i, agg[i]] = w[i]);
    scale: omega / rho(D^-1 A).
    Returns (P_csr, A_coarse_csr) as scipy matrices in Ssp's dtype,
    equal to smooth_prolongator / galerkin_product's values up to
    summation order (pinned by tests/test_torch_amg.py)."""
    ny, nx = grid
    py, px = block
    n = Ssp.shape[0]
    if n != ny * nx:
        raise ValueError(f"grid {grid} does not cover {n} rows")
    dt = np.result_type(Ssp.dtype, np.float32)
    w = np.asarray(w, dt)

    offA, dataA = band if band is not None else csr_to_band(Ssp)
    dataA = [np.asarray(d, dt) for d in dataA]
    kz = offA.index(0) if 0 in offA else None
    d = dataA[kz] if kz is not None else np.zeros(n, dt)
    dinv = (1.0 / np.where(d != 0, d, 1.0)).astype(dt)

    # M = I - scale * D^-1 A  (same offsets as A, plus 0)
    s = dt.type(scale)
    dataM = [-s * dinv * a for a in dataA]
    if kz is not None:
        offM = list(offA)
        dataM[kz] = dataM[kz] + 1.0
    else:
        offM = sorted(offA + [0])
        z = offM.index(0)
        dataM.insert(z, np.ones(n, dt))

    # K = M^T (A M): the fine-grid stencil whose T-fold is A_coarse
    offAM, dataAM = band_mul(offA, dataA, offM, dataM)
    offMt, dataMt = band_transpose(offM, dataM)
    offK, dataK = band_mul(offMt, dataMt, offAM, dataAM)

    nby, ybid, yrem = _block_divmod(ny, py)
    nbx, xbid, xrem = _block_divmod(nx, px)
    nc = nby * nbx

    # ---- P = M T: row i gets (agg[i+o], dataM[o][i] * w[i+o]) ----
    # direct CSR assembly, no scipy COO round trip: each row has at most
    # k_M candidate entries, laid out row-major by a per-row prefix sum over
    # the (small) offset axis, then canonicalised by scipy's C-level
    # sort_indices/sum_duplicates.
    agg = (ybid[:, None] * nbx + xbid[None, :]).reshape(-1).astype(np.int32)
    kM = len(offM)
    cand_cols = np.zeros((kM, n), np.int32)
    cand_vals = np.zeros((kM, n), dt)
    valid = np.zeros((kM, n), bool)
    for k, (o, m_band) in enumerate(zip(offM, dataM)):
        lo, hi = max(0, -o), min(n, n - o)
        v = valid[k]
        v[lo:hi] = m_band[lo:hi] != 0
        band_shift(agg, o, out=cand_cols[k])
        np.multiply(m_band, band_shift(w, o), out=cand_vals[k])
        cand_vals[k][~v] = 0
    counts = valid.sum(axis=0, dtype=np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    # row-major position of each valid candidate: row start + rank of its
    # offset among the row's valid offsets
    rank = np.cumsum(valid, axis=0, dtype=np.int32) - 1
    pos = (indptr[:-1][None, :] + rank)[valid]
    nnzP = int(indptr[-1])
    indices = np.empty(nnzP, np.int32)
    vals = np.empty(nnzP, dt)
    indices[pos] = cand_cols[valid]
    vals[pos] = cand_vals[valid]
    P = sp.csr_matrix((vals, indices, indptr), shape=(n, nc))
    P.sort_indices()
    P.sum_duplicates()

    # ---- A_c = T^T K T: fold each K band into coarse raster bands ----
    # G_o[i] = w[i] * K[i, i+o] * w[i+o]; the (y, x) -> (y//py, x//px)
    # regrouping sends residue (ry, rx) of fine offset (dy, dx) to coarse
    # offset (floor((ry+dy)/py), floor((rx+dx)/px)).
    pad_y, pad_x = nby * py - ny, nbx * px - nx
    acc: Dict[int, np.ndarray] = {}
    wsh = np.empty(n, dt)
    G = np.empty(n, dt)
    for o, k_band in zip(offK, dataK):
        band_shift(w, o, out=wsh)
        np.multiply(k_band, wsh, out=G)
        np.multiply(G, w, out=G)
        if not np.any(G):
            continue
        dy = int(np.rint(o / nx))
        dx = o - dy * nx
        # decompose can land on (dy +- 1) when |dx| ~ nx/2 — never for
        # real stencils, but keep the arithmetic exact anyway
        if abs(dx) > nx // 2:
            step = 1 if dx > 0 else -1
            dy += step
            dx -= step * nx
        G2 = G.reshape(ny, nx)
        if pad_y or pad_x:
            G2 = np.pad(G2, ((0, pad_y), (0, pad_x)))
        G4 = G2.reshape(nby, py, nbx, px)
        for ry in range(py):
            Dy = (ry + dy) // py
            for rx in range(px):
                Dx = (rx + dx) // px
                oc = Dy * nbx + Dx
                sl = G4[:, ry, :, rx].reshape(-1)
                if not np.any(sl):
                    continue
                cur = acc.get(oc)
                if cur is None:
                    acc[oc] = sl.astype(dt)
                else:
                    np.add(cur, sl, out=cur)
    if acc:
        offC = sorted(acc)
        dataC = [acc[o] for o in offC]
        # out-of-range coarse columns can only carry fold contributions
        # from structurally-zero fine entries; clip them exactly
        ccols = np.arange(nc)
        for k, oc in enumerate(offC):
            dataC[k] = np.where((ccols + oc >= 0) & (ccols + oc < nc),
                                dataC[k], 0)
        A_c = band_to_scipy(offC, dataC, (nc, nc))
    else:
        A_c = sp.csr_matrix((nc, nc), dtype=dt)
    return P.astype(Ssp.dtype), A_c.astype(Ssp.dtype)
