"""Stand-ins for the Williams/Bell-Garland SpMV benchmark suite (counterpart
of cusp_autotuned_tpu/gallery/suite.py).

The 14 unstructured matrices and 5 Laplacian stencils of the reference's
performance/spmv/scripts/benchmark.py:13-37 live on SuiteSparse, so each
entry is synthesised with numpy with the structural character of the
original (size class, entries per row, bandedness or scatter, hub rows,
rectangularity), scaled by `scale`.  The draws and seeds are the JAX
package's, so williams_suite gives the same scipy matrices in both.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import scipy.sparse as sp
import torch

# the entries whose rows scatter over the columns: the scattered-pattern
# rails' home in the reference
SCATTERED = ("Economics", "FEM/Accelerator", "Circuit", "Webbase", "LP")


def _fem_band(n, nnz_per_row, block=6, jitter=0.3, seed=0):
    """FEM-style banded matrix: dense node blocks coupled to nearby nodes,
    the pattern family of consph/cant/pwtk/shipsec/rma10."""
    rng = np.random.default_rng(seed)
    nodes = n // block
    half = max(1, nnz_per_row // (2 * block))
    rows, cols = [], []
    for b in range(block):
        # each node couples to `half` neighbours each side, with jitter
        for o in np.arange(-half, half + 1):
            i = np.arange(nodes)
            j = i + o + rng.integers(-int(half * jitter),
                                     int(half * jitter) + 1, nodes)
            j = np.clip(j, 0, nodes - 1)
            for bb in range(block):
                rows.append(i * block + b)
                cols.append(j * block + bb)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = rng.standard_normal(r.size)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _qcd_stencil(L=12, dof=12, seed=0):
    """QCD-like: a 4-D periodic lattice, nearest neighbours, each link
    coupling dof d to d-1, d and d+1 (mod dof)."""
    rng = np.random.default_rng(seed)
    sites = L ** 4
    idx = np.arange(sites).reshape(L, L, L, L)
    rows, cols = [np.arange(sites)], [np.arange(sites)]
    for axis in range(4):
        for d in (-1, 1):
            rows.append(np.arange(sites))
            cols.append(np.roll(idx, d, axis=axis).reshape(-1))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    dd = np.arange(dof)
    rr, cc = [], []
    for shift in (-1, 0, 1):
        rr.append((r[:, None] * dof + dd[None, :]).reshape(-1))
        cc.append((c[:, None] * dof + (dd + shift) % dof).reshape(-1))
    rr = np.concatenate(rr)
    cc = np.concatenate(cc)
    vv = rng.standard_normal(rr.size)
    A = sp.coo_matrix((vv, (rr, cc)),
                      shape=(sites * dof, sites * dof)).tocsr()
    A.sum_duplicates()
    return A


def _powerlaw(n, nnz_target, a=2.1, seed=0):
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(a, n).astype(np.int64), n // 4)
    deg = np.maximum(deg * nnz_target // max(1, deg.sum()), 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _scattered(n, nnz_per_row, seed=0):
    """Economics/accelerator-like: light rows, half of the columns within
    n/50 of the diagonal and half anywhere."""
    rng = np.random.default_rng(seed)
    deg = np.maximum(rng.poisson(nnz_per_row, n), 1)
    rows = np.repeat(np.arange(n), deg)
    local = rows + rng.integers(-n // 50, n // 50 + 1, rows.size)
    anywhere = rng.integers(0, n, rows.size)
    take_local = rng.random(rows.size) < 0.5
    cols = np.clip(np.where(take_local, local, anywhere), 0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _lp_rect(m=1000, n=260_000, nnz_per_row=650, seed=0):
    """LP (rail4284)-like: few very dense rows, wide rectangular."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, rows.size)
    return sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                         shape=(m, n)).tocsr()


def _epidemiology(g):
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    from cusp_autotuned_tpu_torch.gallery.poisson import poisson5pt
    return sp.csr_matrix(to_scipy(poisson5pt(g, g, format="csr", device="cpu")))


def williams_suite(scale: float = 1.0, names=None):
    """OrderedDict name -> scipy CSR stand-in, built on the host.  `names`
    keeps only those entries (each entry draws from its own seed, so a
    subset holds the same matrices as the whole suite)."""
    s = scale
    makers = OrderedDict([
        ("Dense", lambda: sp.csr_matrix(
            np.random.RandomState(0).randn(int(700 * s), int(700 * s)))),
        ("Protein", lambda: _fem_band(int(12_000 * s), 100, block=8,
                                      jitter=0.5, seed=1)),
        ("FEM/Spheres", lambda: _fem_band(int(16_000 * s), 70, block=6, seed=2)),
        ("FEM/Cantilever", lambda: _fem_band(int(16_000 * s), 60, block=3,
                                             seed=3)),
        ("Wind Tunnel", lambda: _fem_band(int(24_000 * s), 50, block=6, seed=4)),
        ("FEM/Harbor", lambda: _fem_band(int(12_000 * s), 50, block=2,
                                         jitter=0.8, seed=5)),
        ("QCD", lambda: _qcd_stencil(L=int(10 * max(s, 0.5)), dof=12, seed=6)),
        ("FEM/Ship", lambda: _fem_band(int(20_000 * s), 55, block=6, seed=7)),
        ("Economics", lambda: _scattered(int(120_000 * s), 6, seed=8)),
        ("Epidemiology", lambda: _epidemiology(int(500 * s))),
        ("FEM/Accelerator", lambda: _scattered(int(70_000 * s), 21, seed=9)),
        ("Circuit", lambda: _powerlaw(int(100_000 * s), int(600_000 * s),
                                      a=2.2, seed=10)),
        ("Webbase", lambda: _powerlaw(int(200_000 * s), int(700_000 * s),
                                      a=1.8, seed=11)),
        ("LP", lambda: _lp_rect(int(1000 * s), int(260_000 * s),
                                int(650 * s) or 650, seed=12)),
    ])
    if names is not None:
        unknown = sorted(set(names) - set(makers))
        if unknown:
            raise KeyError(f"no suite entries {unknown}")
    return OrderedDict((name, make()) for name, make in makers.items()
                       if names is None or name in names)


def stencil_suite(scale: float = 1.0, dtype=torch.float32, device=None):
    """The 5 Laplacian stencils (3/5/7/9/27-pt) as DIA containers on
    `device`, by default the CUDA device."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    s = scale
    n1 = int(1_000_000 * s)
    g2 = int(1000 * np.sqrt(s))
    g3 = int(100 * s ** (1 / 3))
    T = sp.diags([np.full(n1 - 1, -1.0), np.full(n1, 2.0),
                  np.full(n1 - 1, -1.0)], [-1, 0, 1], format="coo")
    out = OrderedDict()
    out["Laplacian_3pt"] = from_scipy(T, "dia", dtype=dtype, device=device)
    out["Laplacian_5pt"] = gallery.poisson5pt(g2, g2, format="dia", dtype=dtype,
                                              device=device)
    out["Laplacian_7pt"] = gallery.poisson7pt(g3, g3, g3, format="dia",
                                              dtype=dtype, device=device)
    out["Laplacian_9pt"] = gallery.poisson9pt(g2, g2, format="dia", dtype=dtype,
                                              device=device)
    out["Laplacian_27pt"] = gallery.poisson27pt(g3, g3, g3, format="dia",
                                                dtype=dtype, device=device)
    return out
