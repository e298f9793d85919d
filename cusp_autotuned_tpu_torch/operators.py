"""Linear operators (counterpart of cusp_autotuned_tpu/operators.py; parity
target cusp/linear_operator.h): the identity, a wrapped function, and a
planned SpMV kernel whose tensors the operator holds.  An operator applies
to a vector (n,) or a dense block (n, k) and exposes num_rows, num_cols
and, when it was planned from a matrix, that matrix's dtype and device, as
the eigensolvers read them."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

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


OPERATOR_TYPES = (IdentityOperator, FunctionOperator, PlannedOperator)


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
    return FunctionOperator(fn=fn, shape=tuple(A.shape), dtype=A.dtype,
                            device=A.device)


def as_operator(M):
    """Normalise None / container / callable to an operator."""
    if M is None:
        return IdentityOperator()
    if isinstance(M, OPERATOR_TYPES + (MatrixBase,)):
        return M
    if callable(M):
        return FunctionOperator(fn=M)
    raise TypeError(f"cannot use {type(M)} as a linear operator")
