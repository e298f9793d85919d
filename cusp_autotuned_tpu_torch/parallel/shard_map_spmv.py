"""Distributed SpMV and CG with each entry's work written out (counterpart
of cusp_autotuned_tpu/parallel/shard_map_spmv.py, whose per-device
programs run under jax.shard_map).

Each mesh entry owns a contiguous row block of the operator and computes
its y block on its device.  The JAX functions' collectives become copies
through the home device: an all-gather is torch.cat of the blocks there,
a psum of dot products a sum there, and the halo's two ppermutes are
copies of band edges between neighbouring entries.

- DIA (queue row 11): the bands of parallel/sharded_plans.py's
  shard_planned_dia, each applied by the DIA band kernel to a replicated,
  left-padded x, or in distributed_cg_halo to its own block with its
  neighbours' edges.
- Unstructured (queue row 12): equal row bands, each planned by the port's
  own binned (kernels/binned.py, csrc/binned_spmv.cu) or COO
  (kernels/colsort.py, csrc/coo_spmv.cu) builder, one launch a band, x
  replicated.  These functions take the port's configuration keys; the JAX
  TPU tiling keys (block_entries, col_window, row_window) raise.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.kernels.binned import build_binned
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort
from cusp_autotuned_tpu_torch.kernels.dia import dia_band_spmv
from cusp_autotuned_tpu_torch.parallel.sharded import (
    RowMesh, fixed_cg, gather, replicate,
)
from cusp_autotuned_tpu_torch.parallel.sharded_plans import (
    _check_keys, _host_csr, partitioned, row_parts, shard_planned_dia,
)
from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException

TPU_KEYS = ("block_entries", "col_window", "row_window")


def sharded_spmv_dia_shardmap(A: F.DIA, mesh: RowMesh, axis: str = "rows"):
    """fn(x) = A @ x with the DIA data in row bands over the mesh and x
    replicated: the banded via_dia operator (shard_planned_dia)."""
    if not isinstance(A, F.DIA):
        raise NotImplementedException("the banded DIA SpMV takes DIA")
    return shard_planned_dia(A, mesh)


def _bands_of(op, v):
    """v (n,) on the home device cut into op's row bands, each on its
    entry's device, padded with zeros to op's padded row count."""
    band = op.arrays[0]["data"].shape[1]
    v = torch.nn.functional.pad(v, (0, band * op.mesh.size - v.shape[0]))
    return [v[i * band:(i + 1) * band].to(d) for i, d in enumerate(op.mesh.devices)]


def _block_cg(op, b, iterations, spmv):
    """CG on row-block vectors: each entry updates its blocks on its device,
    the dot products are summed on the home device (the psum), spmv maps
    the p blocks to the y blocks.  Returns (x, residual norm) on the home
    device."""
    home = op.mesh.home

    def pdot(us, vs):
        return sum(torch.vdot(u, v).to(home) for u, v in zip(us, vs))

    def scaled(s, vs):
        return [s.to(v.device) * v for v in vs]

    b_blk = _bands_of(op, torch.as_tensor(b).to(home))
    x = [torch.zeros_like(v) for v in b_blk]
    r = p = b_blk
    rz = pdot(r, r)
    for _ in range(iterations):
        y = spmv(p)
        alpha = rz / pdot(p, y)
        x = [xi + si for xi, si in zip(x, scaled(alpha, p))]
        r = [ri - si for ri, si in zip(r, scaled(alpha, y))]
        rz_new = pdot(r, r)
        p = [ri + si for ri, si in zip(r, scaled(rz_new / rz, p))]
        rz = rz_new
    return gather(x, op.mesh)[:op.shape[0]], torch.sqrt(rz.real)


def _square_dia(A, what):
    if not isinstance(A, F.DIA):
        raise NotImplementedException(f"{what} currently takes DIA")
    if A.num_rows != A.num_cols:
        raise NotImplementedException(f"{what} needs a square matrix")


def distributed_cg_shardmap(A: F.DIA, b, mesh: RowMesh, iterations: int = 25,
                            axis: str = "rows"):
    """CG with x, r and p kept in row blocks on the entries' devices: each
    iteration gathers p on the home device, pads it and copies it to every
    distinct device for the band kernels (the all-gather), and sums the dot
    products there.  Returns (x, residual norm)."""
    _square_dia(A, "shard_map CG")
    op = shard_planned_dia(A, mesh)

    def spmv(p_blk):
        xs = replicate(op.x_prep(gather(p_blk, mesh)[:A.num_cols]), mesh)
        return [op.band_apply(a, xi, i) for i, (a, xi) in enumerate(zip(op.arrays, xs))]

    return _block_cg(op, b, iterations, spmv)


def distributed_cg_halo(A: F.DIA, b, mesh: RowMesh, iterations: int = 25,
                        axis: str = "rows"):
    """CG with halo exchange: each entry's band kernel reads its own p block
    between the last `left` entries of the previous block and the first
    `right` of the next (zeros at the ends), copied from its neighbours,
    where left and right are the diagonals' reach below and above.  Each
    iteration moves O(bandwidth) entries between neighbours, not the whole
    vector.  Raises where the reach exceeds a band.  Returns (x, residual
    norm)."""
    _square_dia(A, "halo CG")
    op = shard_planned_dia(A, mesh)
    left = -min(0, min(A.offsets))
    right = max(0, max(A.offsets))
    band = op.arrays[0]["data"].shape[1]
    if left > band or right > band:
        raise NotImplementedException(
            "diagonal span exceeds the per-device block; use the all-gather path")
    # the JAX halo is the reach rounded up to 128 lanes, and its second
    # refusal (halo wider than the block) follows from the first on its
    # 128-multiple blocks; here the halo is the reach itself
    reach = (min(A.offsets), max(A.offsets))
    nd = mesh.size

    def spmv(p_blk):
        out = []
        for i, (arrs, v) in enumerate(zip(op.arrays, p_blk)):
            lh = (p_blk[i - 1][band - left:] if i > 0
                  else v.new_zeros(left)).to(v.device)
            rh = (p_blk[i + 1][:right] if i + 1 < nd
                  else v.new_zeros(right)).to(v.device)
            x_ext = torch.cat([lh, v, rh])
            out.append(dia_band_spmv(arrs["data"], arrs["offsets"], x_ext, left,
                                     0, reach))
        return out

    return _block_cg(op, b, iterations, spmv)


def sharded_spmv_binned_shardmap(A, mesh: RowMesh, config=None,
                                 axis: str = "rows"):
    """fn(x) = A @ x for an unstructured A with the row-binned kernel over
    the mesh (queue row 12): equal row bands, each planned by build_binned
    with the port's keys (threads_per_row, hub_cap, block_size,
    value_dtype) and launched once a call on its entry's device, x
    replicated, the bands gathered on the home device."""
    cfg = dict(config or {})
    _check_keys(cfg, TPU_KEYS)
    return partitioned(row_parts(_host_csr(A), mesh), mesh, build_binned, cfg,
                       A.shape, "binned_sharded", dtype=A.dtype)


def sharded_spmv_colsort_shardmap(A, mesh: RowMesh, config=None,
                                  axis: str = "rows"):
    """fn(x) = A @ x with the nnz-balanced COO kernel (the port's colsort)
    over the mesh: equal row bands, each planned by build_colsort with the
    port's keys (values_per_thread, block_size, value_dtype)."""
    cfg = dict(config or {})
    _check_keys(cfg, TPU_KEYS)
    return partitioned(row_parts(_host_csr(A), mesh), mesh, build_colsort, cfg,
                       A.shape, "colsort_sharded", dtype=A.dtype)


def distributed_cg_binned(A, b, mesh: RowMesh, config=None, iterations: int = 25,
                          axis: str = "rows", impl: str = "binned"):
    """Fixed-iteration CG on an unstructured square A through the sharded
    binned (or, impl="colsort", COO) SpMV, vectors on the home device.
    Returns (x, residual norm)."""
    if A.shape[0] != A.shape[1]:
        raise NotImplementedException("distributed CG needs a square matrix")
    builder = (sharded_spmv_colsort_shardmap if impl == "colsort"
               else sharded_spmv_binned_shardmap)
    spmv = builder(A, mesh, config)
    return fixed_cg(spmv, torch.as_tensor(b).to(mesh.home), iterations)
