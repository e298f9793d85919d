"""SpGEMM — sparse × sparse multiply by ESC (expand, sort, compress)
(counterpart of cusp_autotuned_tpu/ops/spgemm.py; parity target the
reference's COO ESC SpGEMM, cusp/system/cuda/detail/multiply/spgemm.h, with
its capped workspace, and generalized_spgemm, cusp/detail/multiply.inl:114-151).

Plain PyTorch on the operands' device, as the JAX package's SpGEMM is XLA
outside any Pallas kernel:

  plan      A's entries (row, col, val), B's CSR arrays, and the running
            sum (int64) of each A entry's expansion length, B's row length
            at its column; only the total, the slice bounds and each
            slice's expansion length cross to the host;
  expand    one slice of A's entries at a time: each expanded slot finds
            its A entry by a searchsorted into the slice's offsets, gathers
            the B entry it pairs with, and multiplies (or `combine`s) the
            two values;
  sort      one stable sort of the int64 key row * num_cols + col (the JAX
            package sorts two keys at once; torch has no such sort);
  compress  the duplicates of a key merged into one entry by a segmented
            reduction in a fixed order (torch.segment_reduce over
            unique_consecutive's counts), never by atomics, so two calls on
            the card give the same bits.

A product is sliced over A's entries so that no slice expands past
MAX_WORKSPACE slots (the reference's min(nnz, 16 << 20) cap); the slices'
compressed entries are merged by one more sort and compress.  C is a
padded sorted COO on A's device (padding: row = num_rows, col = 0, val =
0), converted to A's format; a CSR C is built on the device.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import List, Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up

# cap on the expanded-workspace length of a single slice (entries); mirrors
# the reference's min(nnz, 16<<20) workspace cap
MAX_WORKSPACE = 16 << 20

# builtins and numpy ufuncs as the torch functions of two tensors that a
# semiring's combine and reduce are applied as (the JAX package's
# _normalize_op maps the same ones to jnp)
_TORCH_OPS = {min: torch.minimum, max: torch.maximum,
              operator.add: torch.add, operator.mul: torch.mul,
              operator.sub: torch.sub,
              np.add: torch.add, np.multiply: torch.mul,
              np.subtract: torch.sub,
              np.minimum: torch.minimum, np.maximum: torch.maximum}
# the reduces that torch.segment_reduce computes itself
_SEGMENT_MODES = {torch.add: "sum", torch.mul: "prod", torch.multiply: "prod",
                  torch.minimum: "min", torch.maximum: "max"}
_SCATTER_MODES = {"prod": "prod", "min": "amin", "max": "amax"}


def normalize_op(fn):
    """A builtin or numpy combine/reduce as its torch function; any other
    callable as it is."""
    return _TORCH_OPS.get(fn, fn)


@dataclasses.dataclass
class Plan:
    """A product's device arrays and its slices: `bounds` holds, for each
    slice, (first A entry, one past its last, first expanded slot, one
    past its last)."""
    a_row: torch.Tensor
    a_col: torch.Tensor
    a_val: torch.Tensor
    b_indptr: torch.Tensor
    b_col: torch.Tensor
    b_val: torch.Tensor
    cum: torch.Tensor                  # (nnz(A) + 1,) int64 expansion offsets
    bounds: List[Tuple[int, int, int, int]]
    shape: Tuple[int, int]


def entries(A):
    """(row, col, val) of A's stored entries on its device, int64 indices;
    a permutation matrix's values are float32 ones, as in the JAX package."""
    if isinstance(A, F.PermutationMatrix):
        n = A.shape[0]
        return (torch.arange(n, device=A.device), A.perm.long(),
                torch.ones(n, dtype=torch.float32, device=A.device))
    from cusp_autotuned_tpu_torch.ops.multiply import coo_view
    row, col, val = coo_view(A)
    return row.long(), col.long(), val


def csr_arrays(B):
    """(indptr, col, val) of B on its device, int64 indices: a CSR's own
    arrays, else its entries grouped by row and their row offsets."""
    if isinstance(B, F.CSR):
        return B.indptr.long(), B.col[:B.nnz].long(), B.val[:B.nnz]
    row, col, val = entries(B)
    if isinstance(B, F.HYB):              # its ELL part, then its COO part
        order = torch.sort(row, stable=True).indices
        row, col, val = row[order], col[order], val[order]
    bounds = torch.arange(B.num_rows + 1, device=row.device)
    return torch.searchsorted(row, bounds), col, val


def plan(A, B) -> Plan:
    """The arrays and slices of C = A B.  Host reads: the expansion's total,
    and two scalars a slice where it passes MAX_WORKSPACE."""
    if A.num_cols != B.num_rows:
        raise InvalidInputException(f"dimension mismatch: {A.shape} @ {B.shape}")
    if A.device != B.device:
        raise InvalidInputException(
            f"operands on different devices: {A.device} and {B.device}")
    a_row, a_col, a_val = entries(A)
    b_indptr, b_col, b_val = csr_arrays(B)
    nnz_a = a_col.numel()
    cum = torch.zeros(nnz_a + 1, dtype=torch.int64, device=a_col.device)
    if nnz_a:
        torch.cumsum((b_indptr[1:] - b_indptr[:-1])[a_col], 0, out=cum[1:])
    total = int(cum[-1])
    bounds = []
    if 0 < total <= MAX_WORKSPACE:
        bounds.append((0, nnz_a, 0, total))
    elif total:
        start, first = 0, 0
        while start < nnz_a:
            target = torch.tensor([first + MAX_WORKSPACE], device=cum.device)
            stop = int(torch.searchsorted(cum, target, right=True)) - 1
            stop = max(stop, start + 1)
            last = int(cum[stop])
            bounds.append((start, stop, first, last))
            start, first = stop, last
    return Plan(a_row, a_col, a_val, b_indptr, b_col, b_val, cum, bounds,
                (A.num_rows, B.num_cols))


def expand(p: Plan, bound, combine=None):
    """The keys (row * num_cols + col, int64) and values of one slice's
    expanded products, in A's entry order, then B's."""
    start, stop, first, last = bound
    slot = torch.arange(first, last, device=p.cum.device)
    k = torch.searchsorted(p.cum[start:stop + 1], slot, right=True) + (start - 1)
    bidx = p.b_indptr[p.a_col[k]] + (slot - p.cum[k])
    del slot
    key = p.a_row[k] * p.shape[1] + p.b_col[bidx]
    av, bv = p.a_val[k], p.b_val[bidx]
    return key, (av * bv if combine is None else combine(av, bv))


def segment_merge(vals, counts, reduce=None):
    """Reduce consecutive runs of vals, of lengths `counts`, in a fixed
    order: torch.segment_reduce for sum, prod, min and max of floating
    values (a complex sum as its real and imaginary parts), a scatter for
    integers (whose sum is the same in any order), and
    ops.segment.segment_reduce's scan for any other associative reduce."""
    mode = _SEGMENT_MODES.get(torch.add if reduce is None else reduce)
    if vals.is_complex() and mode == "sum":
        out = torch.segment_reduce(torch.view_as_real(vals), "sum",
                                   lengths=counts, unsafe=True)
        return torch.view_as_complex(out.contiguous())
    if mode is not None and vals.is_floating_point():
        # as one column: on the card a 1-D input takes a block-per-segment
        # reduction, ~44x slower on SpGEMM's short segments than the column
        # layout's, with the same bits (benchmarks/spgemm_compress.py)
        return torch.segment_reduce(vals[:, None], mode, lengths=counts,
                                    unsafe=True)[:, 0]
    seg = torch.repeat_interleave(torch.arange(counts.numel(), device=vals.device),
                                  counts)
    if mode is not None and not vals.is_complex():
        out = vals.new_zeros(counts.numel())
        if mode == "sum":
            return out.index_add_(0, seg, vals)
        return out.scatter_reduce_(0, seg, vals, _SCATTER_MODES[mode],
                                   include_self=False)
    from cusp_autotuned_tpu_torch.ops.segment import segment_reduce
    return segment_reduce(vals, seg, counts.numel(), reduce)[0]


def sort_compress(key, vals, reduce=None):
    """Sort (key, value) pairs stably by key and merge each key's values
    into one: (unique keys, merged values)."""
    key, order = torch.sort(key, stable=True)
    vals = vals[order]
    key, counts = torch.unique_consecutive(key, return_counts=True)
    return key, segment_merge(vals, counts, reduce)


def coo_of_keys(key, vals, shape, dtype, device):
    """The padded sorted COO holding the compressed entries."""
    m, n = shape
    nnz = key.numel()
    npad = max(LANE, round_up(nnz, LANE))
    row = torch.full((npad,), m, dtype=torch.int32, device=device)
    col = torch.zeros(npad, dtype=torch.int32, device=device)
    val = torch.zeros(npad, dtype=dtype, device=device)
    if nnz:
        row[:nnz] = key // n
        col[:nnz] = key % n
        val[:nnz] = vals
    return F.COO(row=row, col=col, val=val, shape=(m, n), nnz=nnz)


def coo_to_csr(C):
    """A padded sorted COO as a CSR on its device (the CSR's expanded row
    ids are the COO's rows, padding included)."""
    bounds = torch.arange(C.num_rows + 1, dtype=C.row.dtype, device=C.device)
    indptr = torch.searchsorted(C.row[:C.nnz], bounds, out_int32=True)
    return F.CSR(indptr=indptr, col=C.col, val=C.val, row=C.row,
                 shape=C.shape, nnz=C.nnz)


def as_format(C, fmt):
    """C (a padded sorted COO) in format `fmt`: CSR on the device, DIA,
    ELL, ELLR and HYB through ops.convert, anything else COO."""
    if fmt == "csr":
        return coo_to_csr(C)
    if fmt in ("dia", "ell", "ellr", "hyb"):
        from cusp_autotuned_tpu_torch.ops.convert import convert
        return convert(C, fmt)
    return C


def spgemm(A, B, initialize=None, combine=None, reduce=None):
    """C = A @ B, or its semiring generalisation: C_ij = reduce over k of
    combine(A_ik, B_kj), over the k where both are stored.  combine and
    reduce are functions of two tensors, or builtins and numpy ufuncs
    (min, max, operator.add, np.minimum, ...), taken as their torch
    functions; reduce must be associative.  `initialize` is accepted for
    the reference's signature and ignored, as in the JAX package: an entry
    of C is the reduction of its products alone.  C takes A's format (COO
    where A is a permutation matrix) on A's device."""
    combine = normalize_op(combine) if combine is not None else None
    reduce = normalize_op(reduce) if reduce is not None else None
    out_fmt = getattr(A, "format", "coo")
    p = plan(A, B)
    device = p.a_val.device
    dtype = torch.promote_types(p.a_val.dtype, p.b_val.dtype)
    pieces = []
    for bound in p.bounds:
        key, vals = expand(p, bound, combine)
        pieces.append(sort_compress(key, vals, reduce))
        del key, vals
    if not pieces:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return as_format(coo_of_keys(empty, None, p.shape, dtype, device), out_fmt)
    if len(pieces) == 1:
        key, vals = pieces[0]
    else:
        key, vals = sort_compress(torch.cat([k for k, _ in pieces]),
                                  torch.cat([v for _, v in pieces]), reduce)
    del pieces
    return as_format(coo_of_keys(key, vals, p.shape, vals.dtype, device), out_fmt)
