"""Padding helpers.

The JAX package pads the major axes of COO/CSR/DIA to the TPU's 128-wide
vector lane.  The GPU kernels need no such alignment; the port keeps the
same padded lengths only so that its containers hold arrays of the same
shape as the reference's, which the parity tests compare directly.  The
JAX module's SUBLANE and pad_axis_to, which tile arrays for the TPU's
(8, 128) vector registers, are not ported: nothing here tiles that way.
"""

import numpy as np

LANE = 128


def round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def pad_to(arr, n: int, fill=0):
    """Pad a 1-D numpy array to length n with `fill`."""
    arr = np.asarray(arr)
    if arr.shape[0] == n:
        return arr
    if arr.shape[0] > n:
        raise ValueError(f"cannot pad length {arr.shape[0]} down to {n}")
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
