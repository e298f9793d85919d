"""DIMACS graph file I/O (counterpart of cusp_autotuned_tpu/io/dimacs.py;
parity target cusp/io/dimacs.h — comment lines 'c ...', the problem line
'p <kind> <nodes> <edges>', arc lines 'a <src> <dst> <weight>' with 1-based
vertex ids, and the max-flow terminals 'n <vertex> s|t')."""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
from cusp_autotuned_tpu_torch.ops.convert import convert, coo_arrays
from cusp_autotuned_tpu_torch.utils.config import resolve_device
from cusp_autotuned_tpu_torch.utils.exceptions import IOException


def read_dimacs_file(path, format: str = "coo", dtype=torch.float32,
                     return_terminals: bool = False, device=None):
    with open(path) as f:
        return read_dimacs_stream(f, format, dtype,
                                  return_terminals=return_terminals,
                                  device=device)


def read_dimacs_stream(stream, format: str = "coo", dtype=torch.float32,
                       return_terminals: bool = False, device=None):
    """With return_terminals, returns (A, (source, sink)): the 0-based
    vertices of the 'n <vertex> s' / 'n <vertex> t' lines, -1 where absent
    (parity: cusp/io/detail/dimacs.inl:44-137)."""
    from cusp_autotuned_tpu_torch.io.matrix_market import torch_dtype
    device = resolve_device(device)
    n = None
    src = snk = -1
    rows, cols, vals = [], [], []
    for line in stream:
        line = line.strip()
        if not line or line.startswith("c"):
            continue
        if line.startswith("p"):
            parts = line.split()
            if len(parts) < 4:
                raise IOException(f"malformed problem line: {line!r}")
            n = int(parts[2])
        elif line.startswith("n"):
            # max-flow terminals 'n <vertex> s|t'; the other variants' node
            # lines ('n <vertex>') pass through
            parts = line.split()
            if len(parts) >= 3 and parts[2][:1] in ("s", "t"):
                if parts[2][0] == "s":
                    src = int(parts[1]) - 1
                else:
                    snk = int(parts[1]) - 1
        elif line.startswith("a"):
            _, u, v, *w = line.split()
            u, v = int(u), int(v)
            if u < 1 or v < 1 or (n is not None and (u > n or v > n)):
                raise IOException("found invalid vertex index")
            rows.append(u - 1)
            cols.append(v - 1)
            vals.append(float(w[0]) if w else 1.0)
    if n is None:
        raise IOException("missing DIMACS problem line")
    A = coo_matrix(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                   np.asarray(vals, np.float64), (n, n), sort=True,
                   dtype=torch_dtype(dtype), device="cpu")
    A = (A if format == "coo" else convert(A, format)).to(device)
    return (A, (src, snk)) if return_terminals else A


def write_dimacs_file(A, path) -> None:
    with open(path, "w") as f:
        write_dimacs_stream(A, f)


def write_dimacs_stream(A, stream) -> None:
    # the 'p max' problem line of the reference's writer
    # (cusp/io/detail/dimacs.inl:160)
    row, col, val, (m, n) = coo_arrays(A)
    stream.write(f"p max {max(m, n)} {val.size}\n")
    for r, c, v in zip(row, col, val):
        stream.write(f"a {int(r) + 1} {int(c) + 1} {v}\n")
