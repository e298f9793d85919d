"""Named math functors (counterpart of cusp_autotuned_tpu/ops/functional.py;
parity target cusp/functional.h and detail/functional.inl — divide_value,
modulus_value, sum_pair_functor, constant_functor, valid_index_functor).

Plain callables over tensors, for API parity and for passing into the
semiring verbs (generalized_spmv, generalized_spgemm).  A non-tensor
argument is taken onto the CUDA device."""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.utils.config import resolve_device


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=resolve_device())


def divide_value(v):
    """x -> x / v (cusp::divide_value)."""
    def f(x):
        return _t(x) / v
    return f


def modulus_value(v):
    """x -> x % v (cusp::modulus_value), with the divisor's sign as in
    Python and numpy."""
    def f(x):
        return _t(x) % v
    return f


def sum_pair(a, b):
    """(a, b) -> a + b over pair-like tuples (cusp::sum_pair_functor)."""
    return tuple(_t(x) + _t(y) for x, y in zip(a, b))


def constant_functor(value):
    """x -> value, shaped like x (cusp::constant_functor)."""
    def f(x):
        return torch.full_like(_t(x), value)
    return f


def valid_index(n):
    """x -> 0 <= x < n (cusp::valid_index_functor, the ELL padding test)."""
    def f(x):
        x = _t(x)
        return (x >= 0) & (x < n)
    return f
