"""Row-sharded sparse operators and distributed Krylov solves (counterpart
of cusp_autotuned_tpu/parallel/sharded.py).

The JAX package places a container's row-parallel arrays on a
jax.sharding.Mesh and lets GSPMD insert the collectives.  Here one Python
process drives a RowMesh, a tuple of torch devices, one per mesh entry, in
which a device may appear more than once: four entries on one card run and
check the whole path there, and the same code drives four cards.

A row-sharded matrix holds one row-block sub-matrix per entry, on that
entry's device, with local rows and global columns.  Vectors live on the
home device, devices[0].  An apply copies x once to each distinct device
(replicate), multiplies each block there, and gathers the row blocks back
to the home device with torch.cat (the all-gather); a solver's dot
products run on the home device (the all-reduce is a sum there).  The
`axis` arguments keep the JAX signatures: a RowMesh has one axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch import formats as F
from cusp_autotuned_tpu_torch.operators import _Shaped, register_operator_type
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D mesh: the device of each entry, the home device first."""
    devices: Tuple[torch.device, ...]
    axis: str = "rows"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_row_mesh(devices=None, axis: str = "rows") -> RowMesh:
    """A RowMesh over `devices` (repeats allowed), by default every visible
    CUDA device.  Without a CUDA device the default raises: the CPU is used
    only where the caller names it, as in make_row_mesh([cpu] * 4)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise InvalidInputException(
                "no CUDA device: make_row_mesh() spans the visible cards; pass "
                "devices=[torch.device('cpu')] * 4 for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise InvalidInputException("a mesh needs at least one device")
    return RowMesh(devices=devices, axis=axis)


def replicate(x, mesh: RowMesh):
    """One copy of x per distinct device of the mesh, as a tuple with an
    entry per mesh entry (entries that share a device share the copy); x
    itself where the device is its own."""
    copies = {x.device: x}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = x.to(d)
    return tuple(copies[d] for d in mesh.devices)


def gather(blocks, mesh: RowMesh):
    """The row blocks, in mesh order, concatenated on the home device."""
    return torch.cat([b.to(mesh.home) for b in blocks])


def row_bands(m: int, n_bands: int):
    """[(r0, r1)]: n_bands equal contiguous row ranges covering [0, m) (the
    last ones empty where m < n_bands)."""
    band = max(1, -(-m // n_bands))
    return [(min(i * band, m), min((i + 1) * band, m)) for i in range(n_bands)]


@register_operator_type
@dataclasses.dataclass(frozen=True)
class ShardedMatrix(_Shaped):
    """A matrix split into row blocks, blocks[i] on mesh.devices[i], rows
    [row_starts[i], row_starts[i + 1]).  Applied as an operator: each block
    through its format's default plan (the kernel on a CUDA device, the
    plain path on the CPU), planned once per rank of x."""
    blocks: Tuple[Any, ...]
    row_starts: Tuple[int, ...]
    mesh: RowMesh
    shape: Tuple[int, int] = (0, 0)
    _plans: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    format = "row_sharded"

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        return self.mesh.home

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.blocks)

    num_entries = nnz

    def _ops(self, x):
        ops = self._plans.get(x.dim())
        if ops is None:
            from cusp_autotuned_tpu_torch.kernels.variants import default_config
            from cusp_autotuned_tpu_torch.operators import planned_operator
            ops = self._plans[x.dim()] = tuple(
                planned_operator(b, default_config(b, x))
                for b in self.blocks)
        return ops

    def __call__(self, x):
        xs = replicate(x, self.mesh)
        return gather([op(xi) for op, xi in zip(self._ops(x), xs)], self.mesh)


def _band_blocks(A, mesh: RowMesh, fmt: str):
    """A's row bands as `fmt` containers on the mesh's devices, each with
    local rows and global columns; DIA keeps its diagonals (offsets shifted
    by the band's first row), the other formats go through their entries."""
    from cusp_autotuned_tpu_torch.formats.base import host_array
    from cusp_autotuned_tpu_torch.ops.convert import convert, coo_arrays
    m, n = A.shape
    bands = row_bands(m, mesh.size)
    blocks = []
    if fmt == "dia":
        data = host_array(A.data)
        for (r0, r1), d in zip(bands, mesh.devices):
            blocks.append(F.dia_matrix(np.add(A.offsets, r0), data[:, r0:r1],
                                       (r1 - r0, n), dtype=A.dtype, device=d))
    else:
        row, col, val, _ = coo_arrays(A)
        cuts = np.searchsorted(row, [r for r, _ in bands] + [m])
        for i, ((r0, r1), d) in enumerate(zip(bands, mesh.devices)):
            s = slice(cuts[i], cuts[i + 1])
            coo = F.coo_matrix(row[s] - r0, col[s], val[s], (r1 - r0, n),
                               sort=False, dtype=A.dtype, device=d)
            blocks.append(convert(coo, fmt))
    return ShardedMatrix(blocks=tuple(blocks),
                         row_starts=tuple(r for r, _ in bands) + (m,),
                         mesh=mesh, shape=(m, n))


def shard_rows(A, mesh: RowMesh, axis: str = "rows"):
    """A's rows in equal bands over the mesh, one row-block sub-matrix of
    A's format per entry.  COO and CSR take the row-aligned split of
    shard_rows_aligned: the JAX package's nnz-blocked placement of their
    entries, whose segment sums GSPMD combines across devices, has no
    single-controller counterpart."""
    if isinstance(A, ShardedMatrix):
        return A
    if not F.is_sparse(A):
        raise TypeError(f"cannot shard {type(A)}")
    return _band_blocks(A, mesh, A.format)


def shard_rows_aligned(A, mesh: RowMesh, axis: str = "rows"):
    """Row-aligned split: each entry owns a contiguous row range and the
    entries of its rows, so every segment sum stays on its device.  Blocks
    are CSR for a CSR matrix, COO for any other."""
    return _band_blocks(A, mesh, "csr" if A.format == "csr" else "coo")


def sharded_spmv(A, x):
    """y = A @ x for a row-sharded A (the operator apply)."""
    from cusp_autotuned_tpu_torch.ops.multiply import multiply
    return multiply(A, x)


def distribute_for_solve(A, mesh: RowMesh, *vectors, aligned: bool = True):
    """Shard a sparse A's rows over the mesh (COO/CSR row-aligned; aligned
    is kept for the JAX signature, the port's COO/CSR split being aligned
    either way) and put the vectors on the home device.  An operator A
    stays as it is.  Returns (A, *vectors)."""
    if F.is_sparse(A):
        A = shard_rows_aligned(A, mesh) if A.format in ("coo", "csr") \
            else shard_rows(A, mesh)
    return (A, *(None if v is None else torch.as_tensor(v).to(mesh.home)
                 for v in vectors))


def fixed_cg(apply, b, iterations: int):
    """`iterations` steps of unpreconditioned CG from x = 0 (the recurrences
    of the JAX package's distributed_cg, sharded.py:118-143).  Returns (x,
    the final residual norm)."""
    x = torch.zeros_like(b)
    r = p = b
    rz = torch.vdot(r, r)
    for _ in range(iterations):
        y = apply(p)
        alpha = rz / torch.vdot(y, p)
        x = x + alpha * p
        r = r - alpha * y
        rz_new = torch.vdot(r, r)
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x, torch.sqrt(rz.real)


def distributed_cg(A, b, mesh: RowMesh, iterations: int = 25):
    """Fixed-iteration CG with A row-sharded over the mesh; the dot products
    are sums on the home device.  Returns (x, residual norm)."""
    return fixed_cg(shard_rows(A, mesh), torch.as_tensor(b).to(mesh.home),
                    iterations)


def distributed_bicgstab(A, b, mesh: RowMesh, iterations: int = 25,
                         aligned: bool = True):
    """Fixed-iteration BiCGstab with A row-sharded over the mesh (the
    recurrences of sharded.py:146-186, parity target
    cusp/krylov/detail/bicgstab.inl).  Returns (x, residual norm)."""
    A, b = distribute_for_solve(A, mesh, b, aligned=aligned)
    x = torch.zeros_like(b)
    r = r0h = b
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(iterations):
        rho_new = torch.vdot(r0h, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = A(p)
        alpha = rho_new / torch.vdot(r0h, v)
        s = r - alpha * v
        t = A(s)
        omega = torch.vdot(t, s) / torch.vdot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
    return x, torch.sqrt(torch.vdot(r, r).real)


def replicated_operator(op):
    """A planned operator with no sharded form, applied on the home device
    as it is; its impl says so."""
    if getattr(op, "impl", None) and not op.impl.endswith("_replicated"):
        return dataclasses.replace(op, impl=f"{op.impl}_replicated")
    return op


def distribute_multilevel(M, mesh: RowMesh, cutoff: int = 2048):
    """An AMG hierarchy over the mesh (counterpart of sharded.py:189-285):
    on each level of at least `cutoff` rows the operator the V-cycle
    applies is sharded.

    - A level A on the via_dia rail (planned on the card, or its plain
      version on the CPU) becomes a row-banded ShardedPlannedOperator
      (shard_planned_dia), its storage type carried over; one on the
      binned, colsort2 or routed rail is partitioned over the mesh
      (shard_planned_blocks).  Any other impl has no sharded form and is
      applied on the home device, its impl marked `_replicated`.
    - The factored R and P take the sharded A, and their grid-blocked
      tentative operators are split by rows (shard_structured_tentative).
    - A container the V-cycle multiplies directly (no planned operator in
      its place) is row-sharded.
    Smaller levels, the smoothers' vectors and the coarse inverse stay on
    the home device."""
    from cusp_autotuned_tpu_torch.operators import (
        FactoredProlongator, FactoredRestriction, StructuredTentative,
        StructuredTentativeT)
    from cusp_autotuned_tpu_torch.ops.convert import convert
    from cusp_autotuned_tpu_torch.parallel.sharded_plans import (
        ShardedPlannedOperator, shard_planned_blocks, shard_planned_dia,
        shard_structured_tentative)

    def shard_aop(lvl):
        op = lvl.Aop
        if op is None or isinstance(op, ShardedPlannedOperator):
            return op
        cfg = dict(getattr(op, "config", None) or ())
        impl = getattr(op, "impl", "")
        if impl == "via_dia":
            keep = {k: v for k, v in cfg.items()
                    if k in ("value_dtype", "block_size")}
            return shard_planned_dia(convert(lvl.A, "dia"), mesh, config=keep)
        if impl in ("binned", "colsort2", "routed"):
            return shard_planned_blocks(lvl.A, mesh, config=cfg)
        return replicated_operator(op)

    def place_t(top):
        if isinstance(top, (StructuredTentative, StructuredTentativeT)):
            return shard_structured_tentative(top, mesh)
        return top

    def place_rp(op, container, Aop_s):
        if op is None:
            return None, shard_rows(container, mesh)
        if isinstance(op, FactoredProlongator):
            return dataclasses.replace(op, Top=place_t(op.Top), Aop=Aop_s), container
        if isinstance(op, FactoredRestriction):
            return dataclasses.replace(op, Ttop=place_t(op.Ttop), Aop=Aop_s), container
        return replicated_operator(op), container

    levels = []
    for lvl in M.levels:
        if lvl.A.num_rows < cutoff:
            levels.append(lvl)
            continue
        Aop = shard_aop(lvl)
        A = lvl.A if Aop is not None else shard_rows(lvl.A, mesh)
        Rop, R = place_rp(lvl.Rop, lvl.R, Aop)
        Pop, P = place_rp(lvl.Pop, lvl.P, Aop)
        levels.append(dataclasses.replace(lvl, A=A, R=R, P=P, Aop=Aop,
                                          Rop=Rop, Pop=Pop))
    return dataclasses.replace(M, levels=tuple(levels))
