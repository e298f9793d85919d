"""Synthetic DIA benchmark matrices from the fork (counterpart of
cusp_autotuned_tpu/gallery/generators.py; parity:
cusp::ktt::make_diagonal_matrix / make_diagonal_symmetric_matrix,
cusp/ktt/matrix_generation.h:14-102)."""

from __future__ import annotations

import numpy as np
import torch

from cusp_autotuned_tpu_torch.formats.dia import dia_matrix
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException


def _check_offsets(rows, cols, offsets, what):
    for off in offsets:
        if (-off if off < 0 else 0) >= rows or (0 if off < 0 else off) >= cols:
            raise InvalidInputException(what)


def make_diagonal_matrix(rows, cols, diag_offsets, dtype=torch.float32,
                         device=None):
    """DIA matrix with ones on the given diagonals, on `device` (by default
    the CUDA device)."""
    offsets = sorted(int(o) for o in diag_offsets)
    _check_offsets(rows, cols, offsets,
                   "make_diagonal_matrix: diagonal out of bounds")
    data = np.ones((len(offsets), rows), dtype=np.float64)
    return dia_matrix(np.asarray(offsets, np.int32), data, (rows, cols),
                      dtype=dtype, device=device)


def make_diagonal_symmetric_matrix(rows, cols, offset_step, diagonal_count,
                                   dtype=torch.float32, device=None):
    """Main diagonal plus diagonal_count-1 others spaced offset_step apart,
    centred (symmetric only for odd counts, as in the reference)."""
    start = -offset_step * (diagonal_count // 2)
    offsets = [start + offset_step * i for i in range(diagonal_count)]
    _check_offsets(rows, cols, offsets,
                   "make_diagonal_symmetric_matrix: too many diagonals")
    return make_diagonal_matrix(rows, cols, offsets, dtype, device)
