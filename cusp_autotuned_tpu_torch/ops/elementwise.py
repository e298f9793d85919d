"""Sparse elementwise C = op(A, B) over the union of the two patterns, and
add/subtract (counterpart of cusp_autotuned_tpu/ops/elementwise.py; parity
target cusp/elementwise.h:43-215 and generic/elementwise.inl).

The JAX package merges the patterns on the host in numpy; here it is done
on the operands' device: one concatenation of both entry lists, a sort on
the int64 key row * num_cols + col, and a compress that places each
operand's value in its key's slot.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.ops.spgemm import (
    as_format, coo_of_keys, entries, normalize_op,
)
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException


def elementwise(A, B, op):
    """C_ij = op(a_ij, b_ij) over the union of the patterns, a missing entry
    taken as 0; op is a function of two tensors, or a builtin or numpy ufunc
    taken as its torch function.  C takes A's format (COO for a format that
    has no pattern of its own) on A's device."""
    if tuple(A.shape) != tuple(B.shape):
        raise InvalidInputException(f"shape mismatch {A.shape} vs {B.shape}")
    if A.device != B.device:
        raise InvalidInputException(
            f"operands on different devices: {A.device} and {B.device}")
    op = normalize_op(op)
    ra, ca, va = entries(A)
    rb, cb, vb = entries(B)
    n = A.shape[1]
    keys, slot = torch.unique(torch.cat([ra * n + ca, rb * n + cb]),
                              sorted=True, return_inverse=True)
    dtype = torch.promote_types(va.dtype, vb.dtype)
    a_full = torch.zeros(keys.numel(), dtype=dtype, device=keys.device)
    b_full = torch.zeros_like(a_full)
    a_full[slot[:va.numel()]] = va.to(dtype)
    b_full[slot[va.numel():]] = vb.to(dtype)
    vals = op(a_full, b_full)
    C = coo_of_keys(keys, vals, tuple(A.shape), vals.dtype, keys.device)
    return as_format(C, getattr(A, "format", "coo"))


def add(A, B):
    return elementwise(A, B, torch.add)


def subtract(A, B):
    return elementwise(A, B, torch.sub)
