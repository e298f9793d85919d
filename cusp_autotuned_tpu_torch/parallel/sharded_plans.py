"""Planned operators partitioned over a mesh (counterpart of
cusp_autotuned_tpu/parallel/sharded_plans.py).

Each mesh entry holds only its part's planned tensors, on its device, and
computes only its part's output.  x lives on the home device; one apply
copies the prepared x once to each distinct device, launches one kernel
(or one wrapper) per part, never one per column of a block x, and brings
the parts' outputs back to the home device: concatenated where the parts
are disjoint row bands ("banded"), added where a part holds a slice of
rows that others hold too ("sum").

- shard_planned_dia, queue row 11: the via_dia rail's diagonals in equal
  row bands.  x_prep pads x once with `left` zeros in front, as the JAX
  plan pre-shifts it, and each band's kernel (csrc/dia_spmv.cu and
  csrc/dia_spmm.cu, the band entry points) reads its window of that
  replicated x at its first row, with no bounds tests.
- shard_planned_blocks: the binned, colsort2 and routed rails.  The port's
  kernels store each row's sum (y[r] = acc); they do not add into y, so a
  plan cannot be cut anywhere and its partial outputs summed, as the JAX
  package cuts its block lists.  The rows are cut instead, into parts that
  hold about nnz / n_parts entries each, and each part is planned by the
  rail's own builder.  colsort2's hub rows, the rows longer than its
  threshold, are split by entry over the parts; each part then plans all
  m rows and the partial outputs are added.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.kernels import _build
from cusp_autotuned_tpu_torch.kernels.dia import _pad_rows, dia_band_spmv
from cusp_autotuned_tpu_torch.operators import _Shaped, register_operator_type
from cusp_autotuned_tpu_torch.parallel.sharded import (
    RowMesh, replicate, row_bands, shard_rows,
)
from cusp_autotuned_tpu_torch.utils.config import plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)

RAILS = ("binned", "colsort2", "routed")


@register_operator_type
@dataclasses.dataclass(frozen=True)
class ShardedPlannedOperator(_Shaped):
    """A planned kernel partitioned over a mesh: arrays[i], the planned
    tensors of part i, lie on mesh.devices[i]; band_apply(arrays[i], x, i)
    computes part i's output from its copy of x_prep(x); finish(y, x) cuts
    the combined output to the matrix's rows.  x (n,) or (n, k) lies on the
    home device, and so does the result."""
    arrays: Tuple[dict, ...]
    x_prep: Callable
    band_apply: Callable
    finish: Callable
    mesh: RowMesh
    shape: Tuple[int, int] = (0, 0)
    impl: str = "sharded"
    out_mode: str = "banded"       # "banded": concatenate; "sum": add
    dtype: Any = None

    format = "sharded_planned_operator"

    @property
    def device(self):
        return self.mesh.home

    def __call__(self, x):
        if x.dim() not in (1, 2):
            raise NotImplementedException(
                "sharded planned operators take x of shape (n,) or (n, k)")
        xs = replicate(self.x_prep(x), self.mesh)
        ys = [self.band_apply(arrs, xi, i)
              for i, (arrs, xi) in enumerate(zip(self.arrays, xs))]
        home = self.mesh.home
        if self.out_mode == "sum":
            y = ys[0].to(home)
            for part in ys[1:]:
                y = y + part.to(home)
        else:
            y = torch.cat([part.to(home) for part in ys])
        return self.finish(y, x)


def _check_keys(config, tpu_keys):
    """Raise on the JAX package's TPU tiling keys, which mean nothing to
    the card's kernels (the port never drops a key it was given silently)."""
    given = sorted(k for k in tpu_keys if k in (config or {}))
    if given:
        raise InvalidInputException(
            f"{given}: TPU tiling keys of the JAX package; the port's plans "
            f"take its own configuration keys")


def dia_bands(D, n_bands: int):
    """(data (ndiag, n_bands * band) zero past the matrix's rows, band,
    left, x_rows): D's diagonals in equal row bands and the rows of the
    padded x that every band's window fits in."""
    m, n = D.shape
    band = max(1, -(-m // n_bands))
    mp = band * n_bands
    data = D.data[:, :m]
    if mp > m:
        data = torch.nn.functional.pad(data, (0, mp - m))
    left = -min(0, min(D.offsets))
    right = max(0, max(D.offsets))
    return data, band, left, left + max(n, mp + right)


def shard_planned_dia(D, mesh: RowMesh, config=None, axis: str = "rows"):
    """The via_dia rail in equal row bands over the mesh (queue row 11): a
    DIA container's diagonals split by rows, each band's (ndiag, band)
    slice in the storage type that `value_dtype` names on its entry's
    device, applied by the band kernel with `block_size` threads a block.
    The JAX TPU key block_rows raises."""
    cfg = dict(config or {})
    _check_keys(cfg, ("block_rows",))
    if D.dtype.is_complex:
        raise NotImplementedException("DIA band kernel supports real dtypes only")
    store = plan_value_dtype(cfg, D.dtype)
    block = _build.block_size(cfg)
    m, n = D.shape
    offsets = tuple(D.offsets)
    data, band, left, x_rows = dia_bands(D, mesh.size)
    data = data.to(store)
    arrays = tuple(
        {"data": data[:, i * band:(i + 1) * band].contiguous().to(dev),
         "offsets": torch.tensor(offsets, dtype=torch.int32, device=dev)}
        for i, dev in enumerate(mesh.devices))
    reach = (min(offsets), max(offsets))

    def x_prep(x):
        return _pad_rows(x, left, x_rows - left - n)

    def band_apply(arrs, x_pad, i):
        return dia_band_spmv(arrs["data"], arrs["offsets"], x_pad, left,
                             i * band, reach, block)

    def finish(y, _x):
        return y[:m]

    return ShardedPlannedOperator(
        arrays=arrays, x_prep=x_prep, band_apply=band_apply, finish=finish,
        mesh=mesh, shape=(m, n), impl="via_dia_sharded", dtype=D.dtype)


def _host_csr(A):
    """(A as CSR, its indptr in int64, col, val) on the host."""
    from cusp_autotuned_tpu_torch.formats.base import host_array
    from cusp_autotuned_tpu_torch.ops.convert import convert
    C = convert(A, "csr")
    return (C, host_array(C.indptr).astype(np.int64),
            host_array(C.col[:C.nnz]), host_array(C.val[:C.nnz]))


def row_parts(host, mesh: RowMesh, cuts=None):
    """The rows of a _host_csr tuple cut at `cuts` (n_parts + 1 row
    indices, by default equal bands) into CSR containers on the mesh's
    devices, with local rows and global columns."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    C, indptr, col, val = host
    if cuts is None:
        cuts = [r for r, _ in row_bands(C.num_rows, mesh.size)] + [C.num_rows]
    parts = []
    for i, dev in enumerate(mesh.devices):
        r0, r1 = cuts[i], cuts[i + 1]
        lo, hi = indptr[r0], indptr[r1]
        parts.append(csr_matrix(indptr[r0:r1 + 1] - lo, col[lo:hi], val[lo:hi],
                                (r1 - r0, C.num_cols), dtype=C.dtype, device=dev))
    return parts


def partitioned(parts, mesh: RowMesh, builder, config, shape, impl,
                out_mode="banded", dtype=None):
    """A ShardedPlannedOperator of one CSR container per mesh entry (parts,
    on the entries' devices), each planned with builder(part, config).  A
    part with no entries computes zeros: the rails refuse an empty plan."""
    plans = [builder(part, config) if part.nnz else None for part in parts]

    def band_apply(arrs, x, i):
        if plans[i] is None:
            return torch.zeros((parts[i].num_rows,) + x.shape[1:], dtype=x.dtype,
                               device=x.device)
        return plans[i].apply(arrs, x)

    return ShardedPlannedOperator(
        arrays=tuple({} if p is None else p.planned_arrays for p in plans),
        x_prep=lambda x: x, band_apply=band_apply, finish=lambda y, _x: y,
        mesh=mesh, shape=tuple(shape), impl=impl, out_mode=out_mode,
        dtype=dtype)


def _nnz_cuts(indptr, n_parts):
    """Row cuts that leave about nnz / n_parts entries in each part."""
    targets = np.arange(1, n_parts) * (int(indptr[-1]) / n_parts)
    return [0, *np.searchsorted(indptr, targets).tolist(), indptr.size - 1]


def shard_planned_blocks(A, mesh: RowMesh, config=None, axis: str = "rows",
                         validate: bool = True):
    """A scattered rail's plan (binned, colsort2 or routed, config["impl"])
    partitioned over the mesh: A's rows cut into parts of about nnz /
    n_parts entries, each planned by the rail's builder with the same
    configuration (colsort2's and routed's hub threshold taken from the
    whole matrix, so every part cuts its rows alike), their outputs
    concatenated.  colsort2's hub rows are split by entry over the parts,
    each of which then plans all rows, and the outputs are added.
    validate=True checks one seeded product against the scipy oracle at
    build time and raises NotImplementedException past 5e-4, relative."""
    from cusp_autotuned_tpu_torch.kernels.colsort2 import (
        K_DEFAULT, auto_hub_cap, plan_colsort2)
    from cusp_autotuned_tpu_torch.kernels.variants import build_spmv

    cfg = dict(config or {})
    impl = cfg.get("impl")
    if impl not in RAILS:
        raise NotImplementedException(
            f"shard_planned_blocks supports binned/colsort2/routed, got {impl!r}")
    if A.dtype.is_complex:
        raise NotImplementedException(f"{impl} kernel supports real dtypes only")
    host = _host_csr(A)
    C, indptr = host[0], host[1]
    if impl != "binned":
        cfg.setdefault("hub_cap", auto_hub_cap(C.nnz, C.num_rows))
    hub = np.zeros(0, np.int64)
    if impl == "colsort2":
        thr, cfg["vrow_len"], _ = plan_colsort2(
            indptr, int(cfg.get("vrow_planes") or K_DEFAULT),
            int(cfg.get("vrow_len") or 0), cfg["hub_cap"])
        hub = np.nonzero(np.diff(indptr) > thr)[0]
    if hub.size:
        parts, out_mode = _hub_split_parts(host, hub, mesh), "sum"
    else:
        parts, out_mode = row_parts(host, mesh, _nnz_cuts(indptr, mesh.size)), "banded"
    op = partitioned(parts, mesh, build_spmv, cfg, C.shape, f"{impl}_sharded",
                     out_mode, A.dtype)
    if validate:
        _validate(op, A)
    return op


def _hub_split_parts(host, hub, mesh: RowMesh):
    """Full-height CSR parts (all m rows): part i holds the entries of the
    i-th range of the other rows (about equal entry counts) and the i-th
    slice of the hub rows' entries, in CSR order."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    C, indptr, col, val = host
    m = C.num_rows
    lengths = np.diff(indptr)
    row = np.repeat(np.arange(m), lengths)
    is_hub = np.zeros(m, bool)
    is_hub[hub] = True
    main = ~is_hub[row]
    cuts = _nnz_cuts(np.concatenate([[0], np.cumsum(np.where(is_hub, 0, lengths))]),
                     mesh.size)
    hub_entries = np.nonzero(~main)[0]
    hub_cuts = np.linspace(0, hub_entries.size, mesh.size + 1).astype(np.int64)
    parts = []
    for i, dev in enumerate(mesh.devices):
        keep = main & (row >= cuts[i]) & (row < cuts[i + 1])
        keep[hub_entries[hub_cuts[i]:hub_cuts[i + 1]]] = True
        part_indptr = np.concatenate([[0], np.cumsum(np.bincount(row[keep], minlength=m))])
        parts.append(csr_matrix(part_indptr, col[keep], val[keep], C.shape,
                                dtype=C.dtype, device=dev))
    return parts


def _validate(op, A):
    from cusp_autotuned_tpu_torch.backend.reference import reference_spmv
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(A.num_cols)).to(device=op.device, dtype=A.dtype)
    got = op(x).double().cpu().numpy()
    want = reference_spmv(A, x)
    scale = np.linalg.norm(want) or 1.0
    err = np.linalg.norm(got - want) / scale
    if not err <= 5e-4:
        raise NotImplementedException(
            f"sharded plan failed oracle validation (rel err {err:.2e})")


def shard_structured_tentative(op, mesh: RowMesh, axis: str = "rows"):
    """A StructuredTentative or its transpose as a row-sharded CSR matrix:
    T (fine x coarse) holds one weight a row, w[r] at the coarse id of fine
    row r, so its bands hold the fine weights by rows; T^T's rows are the
    coarse ids, each summing its block's weighted fine values."""
    import scipy.sparse as sp
    from cusp_autotuned_tpu_torch.backend.reference import from_scipy
    from cusp_autotuned_tpu_torch.formats.base import host_array
    from cusp_autotuned_tpu_torch.operators import StructuredTentativeT
    (ny, nx), (py, px) = op.grid, op.block
    nbx = -(-nx // px)
    r = np.arange(ny * nx)
    coarse = (r // nx // py) * nbx + (r % nx) // px
    w = host_array(op.w)
    T = sp.csr_matrix((w, (r, coarse)),
                      shape=(ny * nx, -(-ny // py) * nbx))
    S = T.T.tocsr() if isinstance(op, StructuredTentativeT) else T
    C = from_scipy(S, "csr", dtype=op.w.dtype, device=op.w.device)
    return shard_rows(C, mesh)
