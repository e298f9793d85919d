"""Smoothed-aggregation AMG set-up (counterpart of
cusp_autotuned_tpu/precond/aggregation/__init__.py).

Parity: cusp::precond::aggregation::smoothed_aggregation
(cusp/precond/aggregation/smoothed_aggregation.h:161; per-level sa_level at
:45-68) with the same extend_hierarchy pipeline
(detail/smoothed_aggregation.inl:134-165): strength, aggregate,
fit_candidates, smooth_prolongator, R = P^T, Galerkin RAP; coarsening stops
at min_level_size = 500 rows or 10 levels (cusp/detail/multilevel.h:142).
The result is a Multilevel, a preconditioner for any Krylov solve.

The set-up runs on the host in numpy and scipy, as in the JAX package; the
level containers and the operators the V-cycle applies live on A's device.
With spmv_config={} every level's A, R and P is planned with the cost
model's pick (autotune.cost_model.recommend_config): on a stencil level
that puts A on the DIA kernel, and R and P on the factored form around it
with the grid-blocked tentative operators.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from cusp_autotuned_tpu_torch.backend.reference import to_scipy
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.precond.aggregation.aggregate import (
    detect_grid, mis_aggregate, standard_aggregate, structured_aggregate,
)
from cusp_autotuned_tpu_torch.precond.aggregation.smooth import (
    galerkin_product, smooth_prolongator,
)
from cusp_autotuned_tpu_torch.precond.aggregation.strength import (
    evolution_strength_of_connection, rho_Dinv_A,
    symmetric_strength_of_connection,
)
from cusp_autotuned_tpu_torch.precond.aggregation.structured_rap import (
    container_from_csr, get_band, structured_smooth_rap,
)
from cusp_autotuned_tpu_torch.precond.aggregation.tentative import fit_candidates
from cusp_autotuned_tpu_torch.precond.multilevel import (
    MAX_LEVELS, MIN_LEVEL_SIZE, CoarseLU, Level, Multilevel, coarse_lu,
)
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, NotImplementedException,
)


class _StageClock:
    """Set-up seconds by stage, summed over the levels."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def mark(self, stage):
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - self._t
        self._t = now


def _tuned_level_config(Mx):
    """The tuner's pick for one level's A: its validated walk (against the
    f64 oracle) the first time the matrix's signature is seen, the cached
    results after that."""
    from cusp_autotuned_tpu_torch.autotune.tuner import get_tuner, matrix_signature
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    tuner = get_tuner()
    if not any(r.is_valid()
               for r in tuner.results.get(matrix_signature(Mx), {}).values()):
        x = torch.ones(Mx.num_cols, dtype=Mx.dtype, device=Mx.device)
        tuner.tune(Mx, x, reference_computation=reference_spmv)
    return tuner.best_configuration(Mx)


def _is_symmetric_host(S, tol: float = 1e-6) -> bool:
    """max|S - S^T| <= tol * max|S|: purely relative, so that an operator
    of tiny entries is not passed as symmetric."""
    D = (S - S.T).tocoo()
    if D.nnz == 0:
        return True
    ref = float(np.abs(S.data).max()) if S.nnz else 1.0
    return float(np.abs(D.data).max()) <= tol * ref


def _structured_tentative_ops(T, grid, block):
    """(Top, Ttop), the StructuredTentative pair of a level whose aggregation
    is grid-blocked, or (None, None) where T is not one entry a row."""
    from cusp_autotuned_tpu_torch.operators import (
        StructuredTentative, StructuredTentativeT)
    Tsp = to_scipy(T).tocsr()
    n, nc = Tsp.shape
    if not (np.diff(Tsp.indptr) == 1).all():
        return None, None
    w = torch.from_numpy(np.asarray(Tsp.data)).to(device=T.device, dtype=T.dtype)
    return (StructuredTentative(w=w, grid=grid, block=block, shape=(n, nc)),
            StructuredTentativeT(w=w, grid=grid, block=block, shape=(nc, n)))


def _scalar(value, dtype) -> float:
    """value rounded to a torch dtype, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def _factored_rp(sa, Aop, P, R, omega, rho, wrap, auto=True, structured=None,
                 symmetric=None):
    """(Rop, Pop): the level's R and P applied factored around its planned A,

        P e = T e - s D^-1 (A (T e)),   R r = T^T (r - s A (D^-1 r))

    (s = omega / rho; R only for a symmetric A), or None where the factored
    form is unavailable or, on an unstructured level, priced slower by the
    cost model than the materialised P or R.  A grid-blocked level applies
    T and T^T as StructuredTentative, which streams, so it needs no price."""
    from cusp_autotuned_tpu_torch.operators import (
        FactoredProlongator, FactoredRestriction)
    if Aop is None or sa.T is None:
        return None, None
    if not auto and structured is None:
        # an explicit configuration: the model's prices do not describe it
        return None, None
    if structured is not None:
        want_P = want_R = True
    else:
        from cusp_autotuned_tpu_torch.autotune.cost_model import (
            DEVICE_MODEL, recommend_config)
        _, est_A = recommend_config(sa.A)
        _, est_T = recommend_config(sa.T)
        _, est_P = recommend_config(P)
        _, est_R = recommend_config(R)
        # the factored apply's extra vector traffic: about four fine-level
        # streams (T e written and read, D^-1, A (T e))
        est_elem = 4 * sa.A.num_rows * sa.A.dtype.itemsize \
            / (DEVICE_MODEL["stream_gbps"] * 1e3)
        factored_us = est_T + est_A + est_elem
        want_P, want_R = factored_us < est_P, factored_us < est_R
        if not (want_P or want_R):
            return None, None
    Top = Ttop = None
    if structured is not None:
        Top, Ttop = _structured_tentative_ops(sa.T, *structured)
    if Top is None:
        Top = wrap(sa.T)
    if Top is None:
        return None, None
    Ssp = to_scipy(sa.A)
    d = np.asarray(Ssp.diagonal())
    dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 1.0)
    dinv = torch.from_numpy(dinv.astype(d.dtype)).to(sa.A.device)
    scale = _scalar(omega / max(rho, 1e-30), sa.A.dtype)
    Pop = (FactoredProlongator(Top=Top, Aop=Aop, dinv=dinv, scale=scale,
                               shape=tuple(P.shape)) if want_P else None)
    if symmetric is None:
        symmetric = _is_symmetric_host(Ssp.tocsr())
    Rop = None
    if want_R and symmetric:
        if Ttop is None:
            Tt = container_from_csr(to_scipy(sa.T).T, sa.T.dtype, sa.T.device)
            Ttop = wrap(Tt)
        if Ttop is not None:
            Rop = FactoredRestriction(Ttop=Ttop, Aop=Aop, dinv=dinv, scale=scale,
                                      shape=tuple(R.shape))
    return Rop, Pop


def _planned_impls(fmt):
    """Every impl that the port's build_spmv plans for a format."""
    from cusp_autotuned_tpu_torch.kernels.variants import VARIANTS
    return tuple(VARIANTS[fmt])


def _level_planner(spmv_config):
    """(wrap(Mx, tune_this) -> operator or None, auto) for a spmv_config
    dict: {} is the cost model's pick for each operator, then the format's
    default; a non-empty dict is that configuration for every operator.
    The container path stays only where both refuse."""
    from cusp_autotuned_tpu_torch.autotune.cost_model import recommend_config
    from cusp_autotuned_tpu_torch.kernels.variants import default_config
    from cusp_autotuned_tpu_torch.operators import planned_operator
    auto = not spmv_config

    def wrap(Mx, tune_this=False):
        if tune_this:
            ladder = [_tuned_level_config(Mx)]
        elif auto:
            cfg, _ = recommend_config(Mx)
            ladder = ([cfg] if cfg.get("impl") in _planned_impls(Mx.format)
                      else []) + [default_config(Mx)]
        else:
            ladder = [dict(spmv_config)]
        for cfg in ladder:
            try:
                return planned_operator(Mx, cfg)
            except (FormatConversionException, NotImplementedException):
                continue
        return None

    return wrap, auto


@dataclasses.dataclass
class SALevel:
    """Set-up data kept for one level (parity: sa_level)."""
    A: Any
    aggregates: Any = None
    roots: Any = None
    B: Any = None
    T: Any = None
    rho_DinvA: float = 0.0


def smoothed_aggregation(A, B=None, theta: float = 0.0,
                         omega: float = 4.0 / 3.0,
                         min_level_size: int = MIN_LEVEL_SIZE,
                         max_levels: int = MAX_LEVELS,
                         aggregator: str = "auto",
                         aggregate_block=(3, 3),
                         smoother: str = "jacobi",
                         strength: str = "symmetric",
                         epsilon: float = 4.0,
                         spmv_config=None) -> Multilevel:
    """Build the SA-AMG hierarchy of A.  B: near-nullspace candidate
    (default ones).  aggregator: 'auto' (grid-blocked aggregation where the
    level is a raster-ordered 2-D stencil and strength is the unthresholded
    'symmetric', else standard) | 'standard' | 'structured' (raises where no
    grid is detected) | 'mis' (MIS(2)-rooted, the roots drawn on A's
    device).  smoother: 'jacobi' | 'gauss_seidel' | 'sor' | 'polynomial'
    (Gauss-Seidel and SOR colour each level on its device).  strength:
    'symmetric' (theta threshold) | 'evolution' (epsilon drop factor).

    spmv_config: None (the V-cycle multiplies the containers) | {} (every
    level's A, R and P planned with the cost model's pick) | a kernel
    configuration dict (every operator planned with it) | 'tune' (each
    level's A walked by the cached tuner; R and P take the model's picks).
    A dict {'tune': True, ...} tunes A on levels of at least
    'tune_min_rows' rows (default 4096) and uses the rest of the dict for
    the other operators."""
    from cusp_autotuned_tpu_torch.precond import smoothers as sm

    tune_levels = False
    tune_min_rows = 4096
    if spmv_config == "tune":
        tune_levels, spmv_config = True, {}
    elif isinstance(spmv_config, dict) and spmv_config.get("tune"):
        spmv_config = dict(spmv_config)
        tune_levels = bool(spmv_config.pop("tune"))
        tune_min_rows = int(spmv_config.pop("tune_min_rows", tune_min_rows))

    smoother_factory = {
        "jacobi": sm.jacobi_smoother,
        "polynomial": lambda M, rho: sm.polynomial_smoother(M),
        "gauss_seidel": lambda M, rho: sm.gauss_seidel_smoother(M),
        "sor": lambda M, rho: sm.sor_smoother(M),
    }[smoother]
    if aggregator not in ("auto", "standard", "mis", "structured"):
        raise ValueError(f"unknown aggregator {aggregator!r}")
    aggregate = mis_aggregate if aggregator == "mis" else standard_aggregate
    # structured aggregation ignores the strength graph; 'auto' takes it only
    # under the default unthresholded symmetric strength
    want_structured = (aggregator == "structured"
                       or (aggregator == "auto" and strength == "symmetric"
                           and theta == 0.0))
    if spmv_config is not None:
        wrap, auto = _level_planner(spmv_config)

    sa = SALevel(A=convert(A, "csr"))
    sa.B = (np.ones(A.num_rows, torch.empty(0, dtype=A.dtype).numpy().dtype)
            if B is None else np.asarray(B))
    levels = []
    clock = _StageClock()
    # symmetry carries down a Galerkin hierarchy (A_c = P^T A P): check once
    sym_known = None
    while sa.A.num_rows > min_level_size and len(levels) < max_levels - 1:
        device, dtype = sa.A.device, sa.A.dtype
        band = get_band(sa.A)          # this level's only band; dropped after it
        rho = rho_Dinv_A(sa.A, band=band)
        sa.rho_DinvA = rho
        clock.mark("rho_DinvA")
        structured = None
        if want_structured:
            grid = detect_grid(sa.A)
            if grid is not None:
                sa.aggregates, sa.roots = structured_aggregate(
                    sa.A, block=aggregate_block, grid=grid)
                structured = (grid, tuple(aggregate_block))
            elif aggregator == "structured":
                raise ValueError("aggregator='structured' but no raster grid "
                                 "structure detected in this level's operator")
        if structured is None:
            if strength == "evolution":
                C = evolution_strength_of_connection(sa.A, sa.B, rho_DinvA=rho,
                                                     epsilon=epsilon)
            else:
                C = symmetric_strength_of_connection(sa.A, theta)
            clock.mark("strength")
            sa.aggregates, sa.roots = aggregate(C)
        clock.mark("aggregate")
        T, B_coarse = fit_candidates(sa.aggregates, sa.B, dtype=dtype,
                                     device=device)
        sa.T = T
        clock.mark("fit_candidates")
        Tsp = to_scipy(T).tocsr()
        if structured is not None and (np.diff(Tsp.indptr) == 1).all():
            # the closed-form stencil build of P and A_c (structured_rap)
            P64, Ac64 = structured_smooth_rap(
                to_scipy(sa.A).tocsr(), np.asarray(Tsp.data), structured[0],
                structured[1], omega / max(rho, 1e-30), band=band)
            P = container_from_csr(P64, dtype, device)
            R = container_from_csr(P64.T, dtype, device)
            A_coarse = container_from_csr(Ac64, dtype, device)
        else:
            P = smooth_prolongator(sa.A, T, omega=omega, rho_DinvA=rho)
            R = container_from_csr(to_scipy(P).T, dtype, device)
            A_coarse = galerkin_product(R, sa.A, P)
        del band
        clock.mark("prolongator and RAP")
        Aop = Rop = Pop = None
        if spmv_config is not None:
            tune_A = tune_levels and sa.A.num_rows >= tune_min_rows
            Aop = wrap(sa.A, tune_A)
            if sym_known is not True:
                sym_known = _is_symmetric_host(to_scipy(sa.A).tocsr())
            Rop, Pop = _factored_rp(sa, Aop, P, R, omega, rho, wrap,
                                    auto=auto and not tune_A,
                                    structured=structured, symmetric=sym_known)
            Rop = Rop if Rop is not None else wrap(R)
            Pop = Pop if Pop is not None else wrap(P)
            clock.mark("plan operators")
        levels.append(Level(R=R, A=sa.A, P=P,
                            smoother=smoother_factory(sa.A, rho),
                            Aop=Aop, Rop=Rop, Pop=Pop))
        clock.mark("smoother")
        sa = SALevel(A=A_coarse, B=B_coarse)

    if spmv_config is not None and levels and all(
            lvl.Aop is None and lvl.Rop is None and lvl.Pop is None
            for lvl in levels):
        import warnings
        warnings.warn("spmv_config planned no operator on any level (every "
                      "build was refused); the hierarchy multiplies the "
                      "containers", RuntimeWarning, stacklevel=2)
    coarse = coarse_lu(to_scipy(sa.A).toarray(), sa.A.dtype, sa.A.device)
    clock.mark("coarse LU")
    return Multilevel(levels=tuple(levels), coarse=coarse, shape=tuple(A.shape),
                      setup_s=clock.seconds)
