"""Pretty printers and sparsity plots (counterpart of
cusp_autotuned_tpu/ops/printing.py; parity target cusp/print.h and
cusp/detail/print.inl).  They read the matrix on the host and write the
same text as the JAX package's."""

from __future__ import annotations

import sys

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.base import host_array


def print_matrix(A, stream=None) -> None:
    stream = stream or sys.stdout
    if isinstance(A, (np.ndarray, torch.Tensor)):
        a = host_array(A)
        if a.ndim == 1:
            stream.write(f"array1d <{a.shape[0]}>\n")
            for v in a:
                stream.write(f"  {v}\n")
        else:
            stream.write(f"array2d <{a.shape[0]}, {a.shape[1]}>\n")
            for r in a:
                stream.write("  " + "  ".join(f"{v}" for v in r) + "\n")
        return
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, val, (m, n) = coo_arrays(A)
    stream.write(
        f"sparse matrix <{m}, {n}> with {val.size} entries [{A.format}]\n")
    for r, c, v in zip(row, col, val):
        stream.write(f"  {int(r):>8} {int(c):>8}  {v}\n")


def spy(A, stream=None, max_size: int = 60) -> None:
    """Text sparsity plot — the terminal stand-in for the reference's OpenGL
    spy viewer (cusp/opengl/spy/)."""
    stream = stream or sys.stdout
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, _, (m, n) = coo_arrays(A)
    h = min(m, max_size)
    w = min(n, max_size)
    grid = np.zeros((h, w), dtype=bool)
    grid[(row * h) // max(m, 1), (col * w) // max(n, 1)] = True
    stream.write("+" + "-" * w + "+\n")
    for r in grid:
        stream.write("|" + "".join("*" if c else " " for c in r) + "|\n")
    stream.write("+" + "-" * w + "+\n")


def spy_plot(A, path=None, max_points: int = 200000, markersize=None,
             show: bool = False):
    """Graphical sparsity plot via matplotlib (the interactive side of the
    reference's OpenGL spy, cusp/opengl/spy/spy.h, without its GLUT loop):
    save to `path` (png/svg/pdf) and/or `show` a window.  Returns the
    matplotlib Figure, or None where matplotlib is not installed."""
    try:
        import matplotlib
        if not show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:  # matplotlib is optional: spy and spy_svg always work
        return None
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, _, (m, n) = coo_arrays(A)
    stride = max(1, row.size // max_points)
    row, col = row[::stride], col[::stride]
    fig, ax = plt.subplots(figsize=(6, 6 * max(m, 1) / max(n, 1)))
    if markersize is None:
        markersize = max(0.1, min(2.0, 400.0 / max(m, n, 1)))
    ax.plot(col, row, ".", markersize=markersize, color="black")
    ax.set_xlim(-0.5, n - 0.5)
    ax.set_ylim(m - 0.5, -0.5)
    ax.set_aspect("equal")
    ax.set_title(f"{m} x {n}, {getattr(A, 'nnz', row.size)} entries")
    if path is not None:
        fig.savefig(path, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return fig


def spy_svg(A, path, max_points: int = 20000, size: int = 600) -> None:
    """Write the sparsity pattern as an SVG scatter (the file-output side of
    the reference's OpenGL spy viewer, cusp/opengl/spy/)."""
    from cusp_autotuned_tpu_torch.ops.convert import coo_arrays
    row, col, _, (m, n) = coo_arrays(A)
    stride = max(1, row.size // max_points)
    row, col = row[::stride], col[::stride]
    sx = size / max(n, 1)
    sy = size / max(m, 1)
    r = max(0.5, min(sx, sy) / 2)
    with open(path, "w") as f:
        f.write(f'<svg xmlns="http://www.w3.org/2000/svg" '
                f'width="{size}" height="{size}" '
                f'viewBox="0 0 {size} {size}">\n')
        f.write(f'<rect width="{size}" height="{size}" fill="white"/>\n')
        for i, j in zip(row, col):
            f.write(f'<circle cx="{(j + 0.5) * sx:.1f}" '
                    f'cy="{(i + 0.5) * sy:.1f}" r="{r:.2f}" fill="black"/>\n')
        f.write("</svg>\n")
