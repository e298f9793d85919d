"""Stencil matrices assembled on the device, in plain torch, from a
configuration's grid and stencil points.

A grid is [nx] or [nx, ny] or [nx, ny, nz]; row i of the matrix is the
grid point i = x + nx * (y + ny * z), x fastest.  A stencil point is
[[dx, dy, dz], value]: row i holds `value` at column i + dx + nx * (dy +
ny * dz) where that neighbour lies inside the grid, and nothing where it
does not (Dirichlet truncation, as HPCG and CUSP's gallery assemble
their Laplacians).  A spec may scale the diagonal row by row, as HPCG's
TestCG does: "diagonal_scale": {"first_rows": [s0, s1, ...], "other_rows":
s} multiplies the value of the point at offset 0 by s_i in row i.

The benchmark builds the port's inputs here and not through the port's
gallery: the gallery assembles on the host in numpy, which at HPCG's 449 M
entries would be most of a run's set-up.  The arrays follow the port's
container layouts (formats/dia.py, formats/csr.py): DIA data of shape
(ndiag, rows padded to 128) with out-of-grid slots zero, offsets
ascending; CSR columns ascending within a row, col/val/row padded to a
multiple of 128 with col 0, val 0 and row num_rows.
"""

from __future__ import annotations

import torch

LANE = 128


def round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def points(spec):
    """[(offset tuple, value)] of a configuration's stencil, the offsets
    padded with zeros to the grid's rank, sorted by linear offset."""
    grid = spec["grid"]
    out = []
    for off, value in spec["stencil"]:
        off = tuple(int(o) for o in off) + (0,) * (len(grid) - len(off))
        if len(off) != len(grid):
            raise ValueError(f"stencil offset {off} has more axes than grid {grid}")
        out.append((off, float(value)))
    return sorted(out, key=lambda p: linear_offset(grid, p[0]))


def linear_offset(grid, off) -> int:
    stride, total = 1, 0
    for n, d in zip(grid, off):
        total += d * stride
        stride *= n
    return total


def num_rows(grid) -> int:
    m = 1
    for n in grid:
        m *= int(n)
    return m


def _axis_mask(n: int, d: int, device):
    """(n,) bool: the grid positions whose neighbour at step d on this axis
    lies inside the axis."""
    i = torch.arange(n, device=device)
    return (i + d >= 0) & (i + d < n)


def point_mask(grid, off, device):
    """(m,) bool: the rows whose neighbour at `off` lies inside the grid,
    built as the outer product of one mask per axis."""
    mask = None
    for axis, (n, d) in enumerate(zip(grid, off)):
        a = _axis_mask(int(n), int(d), device)
        # the tensor view is (nz, ny, nx): axis 0 (x) is the last dimension
        a = a.view((n,) + (1,) * axis)
        mask = a if mask is None else mask & a
    return mask.reshape(-1)


def row_scale(spec, dtype, device):
    """(m,) the factor of each row's diagonal, or None where the spec keeps
    the stencil's value in every row."""
    scale = spec.get("diagonal_scale")
    if scale is None:
        return None
    out = torch.full((num_rows(spec["grid"]),), float(scale["other_rows"]),
                     dtype=dtype, device=device)
    first = torch.tensor([float(v) for v in scale["first_rows"]], dtype=dtype)
    out[: first.numel()] = first.to(device)
    return out


def _center(pts) -> int:
    (c,) = [d for d, (off, _) in enumerate(pts) if not any(off)]
    return c


def nnz_of(grid, pts) -> int:
    """Stored entries, counted from the grid alone: a point stores as many
    entries as the product of its in-axis counts."""
    total = 0
    for off, _ in pts:
        c = 1
        for n, d in zip(grid, off):
            c *= max(0, int(n) - abs(int(d)))
        total += c
    return total


def dia_arrays(spec, dtype, device):
    """(data, offsets, shape, nnz) of the stencil as DIA: data (ndiag,
    rows_pad) in `dtype` on `device`, one row of the grid's truncation mask
    times the point's value for each point, made in one fill a diagonal."""
    grid = spec["grid"]
    pts = points(spec)
    m = num_rows(grid)
    rows_pad = max(LANE, round_up(m, LANE))
    data = torch.zeros((len(pts), rows_pad), dtype=dtype, device=device)
    for d, (off, value) in enumerate(pts):
        row = data[d, :m]
        row.copy_(point_mask(grid, off, device))
        row.mul_(value)
    scale = row_scale(spec, dtype, device)
    if scale is not None:
        data[_center(pts), :m].mul_(scale)
    offsets = tuple(linear_offset(grid, off) for off, _ in pts)
    return data, offsets, (m, m), nnz_of(grid, pts)


def csr_arrays(spec, dtype, device):
    """(indptr, col, val, row, shape, nnz) of the stencil as CSR, int32
    indices, the entries of a row in ascending column order, col/val/row
    padded to a multiple of 128."""
    grid = spec["grid"]
    pts = points(spec)
    m = num_rows(grid)
    valid = torch.stack([point_mask(grid, off, device) for off, _ in pts], dim=1)
    offs = torch.tensor([linear_offset(grid, off) for off, _ in pts],
                        dtype=torch.int64, device=device)
    vals = torch.tensor([v for _, v in pts], dtype=dtype, device=device)
    rows = torch.arange(m, dtype=torch.int64, device=device)
    col = (rows[:, None] + offs[None, :])[valid]
    scale = row_scale(spec, dtype, device)
    if scale is None:
        val = vals.expand(m, len(pts))[valid]
    else:
        full = vals.expand(m, len(pts)).clone()
        full[:, _center(pts)] *= scale
        val = full[valid]
    row = rows[:, None].expand(m, len(pts))[valid]
    nnz = nnz_of(grid, pts)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=device)
    torch.cumsum(valid.sum(dim=1), dim=0, out=indptr[1:])
    npad = max(LANE, round_up(nnz, LANE))

    def padded(t, fill, dt):
        out = torch.full((npad,), fill, dtype=dt, device=device)
        out[:nnz] = t
        return out

    return (indptr.to(torch.int32), padded(col, 0, torch.int32),
            padded(val, 0, dtype), padded(row, m, torch.int32), (m, m), nnz)
