"""y = A x for a stencil matrix, by shifted slices of the zero-padded grid.

Works from the configuration's grid and stencil points alone, never from
an assembled matrix: one slice of the padded grid a point, scaled by the
point's value and added in `dtype`.  Where the spec has a
"diagonal_scale" ({"first_rows": [...], "other_rows": s}), the point at
offset 0 is scaled row by row as well.  x is (m,) or (m, k), m the grid's
points with x fastest."""

from __future__ import annotations

import torch


def _points(spec):
    grid = spec["grid"]
    for off, value in spec["stencil"]:
        off = tuple(int(o) for o in off) + (0,) * (len(grid) - len(off))
        yield off, float(value)


def _diagonal(spec, dtype, device):
    """(m,) each row's factor on the point at offset 0, or None."""
    scale = spec.get("diagonal_scale")
    if scale is None:
        return None
    m = 1
    for n in spec["grid"]:
        m *= int(n)
    out = torch.full((m,), float(scale["other_rows"]), dtype=dtype, device=device)
    first = [float(v) for v in scale["first_rows"]]
    out[: len(first)] = torch.tensor(first, dtype=dtype, device=device)
    return out


def apply(spec, x, dtype):
    """A x in `dtype` (x is cast to it first)."""
    grid = [int(n) for n in spec["grid"]]
    pts = list(_points(spec))
    reach = [max(abs(off[a]) for off, _ in pts) for a in range(len(grid))]
    tail = tuple(x.shape[1:])
    dims = tuple(reversed(grid))                    # (nz, ny, nx)
    pads = tuple(reversed(reach))
    X = x.to(dtype).reshape(dims + tail)
    P = torch.zeros(tuple(n + 2 * r for n, r in zip(dims, pads)) + tail,
                    dtype=dtype, device=x.device)
    P[tuple(slice(r, r + n) for n, r in zip(dims, pads))] = X
    y = torch.zeros(dims + tail, dtype=dtype, device=x.device)
    diag = _diagonal(spec, dtype, x.device)
    for off, value in pts:
        if diag is not None and not any(off):
            y.add_(X * (value * diag).reshape(dims + (1,) * len(tail)))
            continue
        shifted = tuple(slice(r + d, r + d + n)
                        for n, r, d in zip(dims, pads, reversed(off)))
        y.add_(P[shifted], alpha=value)
    return y.reshape(x.shape)
