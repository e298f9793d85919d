"""Linear operators (counterpart of cusp_autotuned_tpu/operators.py; parity
target cusp/linear_operator.h): the identity, a wrapped function, a
planned SpMV kernel whose tensors the operator holds, and the smoothed-
aggregation level operators: the factored smoothed prolongator and its
restriction, and the grid-blocked tentative prolongator and its transpose.
An operator applies to a vector (n,) or a dense block (n, k) and exposes
num_rows, num_cols and, when it was planned from a matrix, that matrix's
dtype and device, as the eigensolvers read them."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from cusp_autotuned_tpu_torch.formats.base import MatrixBase


class _Shaped:
    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]


@dataclasses.dataclass(frozen=True)
class IdentityOperator(_Shaped):
    shape: Tuple[int, int] = (0, 0)

    format = "identity_operator"

    def __call__(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class FunctionOperator(_Shaped):
    """Wraps y = fn(x) as an operator."""
    fn: Callable
    shape: Tuple[int, int] = (0, 0)
    dtype: Any = None              # the planned matrix's, where known
    device: Any = None
    impl: str = ""                 # the plan's impl, where planned from a matrix

    format = "function_operator"

    def __call__(self, x):
        return self.fn(x)


@dataclasses.dataclass(frozen=True)
class PlannedOperator(_Shaped):
    """A built SpMV kernel: `arrays` holds its planned tensors, and
    `build(arrays, x)` applies it."""
    arrays: dict
    build: Callable
    shape: Tuple[int, int] = (0, 0)
    impl: str = ""                 # kernel rail label (introspection)
    config: Any = None             # the configuration the plan was built with
    dtype: Any = None              # the planned matrix's (its storage may differ)
    device: Any = None

    format = "planned_operator"

    def __call__(self, x):
        return self.build(self.arrays, x)


def _rows_scaled(v, x):
    """v (n,) times x (n,) or (n, k) row by row."""
    return v * x if x.dim() == 1 else v[:, None] * x


@dataclasses.dataclass(frozen=True)
class FactoredProlongator(_Shaped):
    """The smoothed-aggregation prolongator P = (I - s D^-1 A) T applied
    factored,

        P e = T e - s * (D^-1 * (A (T e))),

    through the level's planned A and tentative T operators (parity:
    smooth_prolongator.h:52-151, where the reference materialises P)."""
    Top: Any                       # tentative prolongator apply
    Aop: Any                       # level operator apply
    dinv: Any                      # 1 / diag(A)
    scale: float                   # omega / rho(D^-1 A), in A's dtype
    shape: Tuple[int, int] = (0, 0)
    impl: str = "factored"

    format = "factored_prolongator"

    def __call__(self, e):
        te = self.Top(e)
        return te - self.scale * _rows_scaled(self.dinv, self.Aop(te))


@dataclasses.dataclass(frozen=True)
class FactoredRestriction(_Shaped):
    """R = P^T applied factored, for a symmetric A:

        R r = T^T (r - s * A (D^-1 * r))."""
    Ttop: Any                      # transposed tentative apply
    Aop: Any
    dinv: Any
    scale: float
    shape: Tuple[int, int] = (0, 0)
    impl: str = "factored"

    format = "factored_restriction"

    def __call__(self, r):
        return self.Ttop(r - self.scale * self.Aop(_rows_scaled(self.dinv, r)))


@dataclasses.dataclass(frozen=True)
class StructuredTentative(_Shaped):
    """The tentative prolongator of a grid-blocked aggregation
    (structured_aggregate: fine row y * nx + x belongs to coarse id
    (y // py) * nbx + x // px), applied as

        T e = w * upsample(e),

    each coarse value repeated over its py x px block of the (ny, nx) grid
    and scaled by the fine row's weight.  The JAX package spells the
    upsample as two 0/1 matrix products, because the TPU has no cheap
    gather; here it is a reshape and repeat_interleave, which computes the
    same values exactly."""
    w: Any                         # (ny * nx,) the weight of each fine row
    grid: Tuple[int, int] = (0, 0)     # ny, nx
    block: Tuple[int, int] = (3, 3)    # py, px
    shape: Tuple[int, int] = (0, 0)
    impl: str = "structured"

    format = "structured_tentative"

    def __call__(self, e):
        (ny, nx), (py, px) = self.grid, self.block
        nby, nbx = -(-ny // py), -(-nx // px)
        tail = e.shape[1:]
        u = e.reshape(nby, nbx, *tail)
        u = u.repeat_interleave(py, dim=0)[:ny].repeat_interleave(px, dim=1)[:, :nx]
        return _rows_scaled(self.w, u.reshape(ny * nx, *tail))


@dataclasses.dataclass(frozen=True)
class StructuredTentativeT(_Shaped):
    """The transpose of StructuredTentative: scale by the weights, then sum
    each py x px block of the (ny, nx) grid (along x first, then y, the
    order of the JAX package's two products)."""
    w: Any
    grid: Tuple[int, int] = (0, 0)
    block: Tuple[int, int] = (3, 3)
    shape: Tuple[int, int] = (0, 0)
    impl: str = "structured"

    format = "structured_tentative_t"

    def __call__(self, z):
        (ny, nx), (py, px) = self.grid, self.block
        nby, nbx = -(-ny // py), -(-nx // px)
        tail = z.shape[1:]
        Z = _rows_scaled(self.w, z).reshape(ny, nx, *tail)
        pad = [0, 0] * len(tail) + [0, nbx * px - nx, 0, nby * py - ny]
        if nby * py != ny or nbx * px != nx:
            Z = torch.nn.functional.pad(Z, pad)
        Z = Z.reshape(nby, py, nbx, px, *tail)
        return Z.sum(3).sum(1).reshape(nby * nbx, *tail)


OPERATOR_TYPES = (IdentityOperator, FunctionOperator, PlannedOperator,
                  FactoredProlongator, FactoredRestriction,
                  StructuredTentative, StructuredTentativeT)


def planned_operator(A, config=None):
    """Build the configured SpMV for A as a PlannedOperator when the builder
    exposes its planned tensors (the cuda kernels), else as a
    FunctionOperator.  config defaults to the format's default_config."""
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv, default_config
    cfg = dict(config) if config is not None else default_config(A)
    fn = build_spmv(A, cfg)
    if hasattr(fn, "planned_arrays"):
        impl = getattr(fn, "plan_stats", {}).get("impl", str(cfg.get("impl", "")))
        return PlannedOperator(arrays=fn.planned_arrays, build=fn.apply,
                               shape=tuple(A.shape), impl=impl,
                               config=tuple(sorted(cfg.items())), dtype=A.dtype,
                               device=A.device)
    impl = getattr(fn, "plan_stats", {}).get("impl", str(cfg.get("impl", "")))
    return FunctionOperator(fn=fn, shape=tuple(A.shape), dtype=A.dtype,
                            device=A.device, impl=impl)


def as_operator(M):
    """Normalise None / container / callable to an operator."""
    if M is None:
        return IdentityOperator()
    if isinstance(M, OPERATOR_TYPES + (MatrixBase,)):
        return M
    if callable(M):
        return FunctionOperator(fn=M)
    raise TypeError(f"cannot use {type(M)} as a linear operator")
