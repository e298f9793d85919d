"""Dense containers: the pitched Array2d and array1d views (counterpart of
cusp_autotuned_tpu/formats/dense.py).

Parity targets:
  - cusp::array1d / array1d_view (cusp/array1d.h:98,361): a vector and a
    strided window of it;
  - cusp::array2d / array2d_view (cusp/array2d.h:144,162): a dense matrix in
    row-major ("c") or column-major ("f") orientation with a pitch (the
    physical minor dimension may exceed the logical one), with row() and
    column() views (cusp/detail/array2d_format_utils.h).

The JAX package rounds the default pitch up to 128 lanes, a TPU layout rule;
here the pitch defaults to the minor dimension, as in cusp::array2d.  Views
are torch views of the buffer where the layout allows, so writes through a
view reach the buffer, as in Thrust (the JAX package's views are copies).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cusp_autotuned_tpu_torch.formats.base import as_tensor
from cusp_autotuned_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class Array2d:
    """Pitched dense matrix.  `values` is the physical buffer: (num_rows,
    pitch) in row-major ("c") orientation, (num_cols, pitch) in
    column-major ("f"); pitch >= the logical minor dimension."""

    values: torch.Tensor
    shape: Tuple[int, int] = (0, 0)
    orientation: str = "c"            # "c" row-major, "f" column-major

    format = "array2d"

    @staticmethod
    def from_dense(a, orientation: str = "c", pitch: Optional[int] = None,
                   device=None) -> "Array2d":
        a = as_tensor(a, device=device)
        if a.dim() != 2:
            raise ValueError("array2d expects a 2-D source")
        if orientation not in ("c", "f"):
            raise ValueError(f"orientation must be 'c' or 'f' (got {orientation!r})")
        m, n = a.shape
        minor = n if orientation == "c" else m
        pitch = minor if pitch is None else int(pitch)
        if pitch < minor:
            raise ValueError(f"pitch {pitch} < minor dimension {minor}")
        body = a if orientation == "c" else a.T
        buf = body.new_zeros((body.shape[0], pitch))
        buf[:, :minor] = body
        return Array2d(values=buf, shape=(int(m), int(n)), orientation=orientation)

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def num_entries(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def pitch(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "Array2d":
        return dataclasses.replace(self, values=self.values.to(device))

    # -- views ----------------------------------------------------------------

    def row(self, i):
        """Row view (cusp::array2d row view, array2d_format_utils.h)."""
        if self.orientation == "c":
            return self.values[i, : self.shape[1]]
        return self.values[: self.shape[1], i]

    def column(self, j):
        """Column view."""
        if self.orientation == "c":
            return self.values[: self.shape[0], j]
        return self.values[j, : self.shape[0]]

    def view(self, rows: slice, cols: slice) -> "Array2d":
        """Sub-matrix as a new Array2d of the same orientation (the JAX
        package's functional make_array2d_view: a copy)."""
        return Array2d.from_dense(self.to_dense()[rows, cols],
                                  orientation=self.orientation)

    # -- interop ---------------------------------------------------------------

    def to_dense(self) -> torch.Tensor:
        """The logical (num_rows, num_cols) matrix, a view of the buffer."""
        m, n = self.shape
        if self.orientation == "c":
            return self.values[:m, :n]
        return self.values[:n, :m].T

    def __array__(self, dtype=None, copy=None):
        a = self.to_dense().detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, ij):
        i, j = ij
        return self.to_dense()[i, j]

    def transpose(self) -> "Array2d":
        """O(1) transpose: flip the orientation, swap the logical dims."""
        return Array2d(values=self.values, shape=(self.shape[1], self.shape[0]),
                       orientation="f" if self.orientation == "c" else "c")

    @property
    def T(self) -> "Array2d":
        return self.transpose()

    def __matmul__(self, other):
        from cusp_autotuned_tpu_torch.ops.multiply import multiply
        return multiply(self.to_dense(), other)


def array2d(num_rows: int, num_cols: int, fill=0, dtype=torch.float32,
            orientation: str = "c", pitch: Optional[int] = None,
            device=None) -> Array2d:
    """A filled pitched array2d (cusp::array2d(m, n, value)) on `device`,
    by default the CUDA device."""
    a = torch.full((num_rows, num_cols), fill, dtype=dtype,
                   device=resolve_device(device))
    return Array2d.from_dense(a, orientation=orientation, pitch=pitch)


def make_array2d_view(buffer, num_rows: int, num_cols: int,
                      orientation: str = "c", device=None) -> Array2d:
    """Wrap a physical buffer (major, pitch) as an Array2d
    (cusp::make_array2d_view).  A tensor is wrapped without a copy; host
    data is copied to `device`, by default the CUDA device."""
    buffer = as_tensor(buffer, device=device)
    if buffer.dim() != 2:
        raise ValueError("buffer must be 2-D (major, pitch)")
    major = num_rows if orientation == "c" else num_cols
    minor = num_cols if orientation == "c" else num_rows
    if buffer.shape[0] != major or buffer.shape[1] < minor:
        raise ValueError(
            f"buffer {tuple(buffer.shape)} cannot view a {num_rows}x{num_cols} "
            f"{orientation}-major matrix")
    return Array2d(values=buffer, shape=(int(num_rows), int(num_cols)),
                   orientation=orientation)


# -- array1d ---------------------------------------------------------------------

def array1d(n: int, fill=0, dtype=torch.float32, device=None) -> torch.Tensor:
    """cusp::array1d(n, value): dense vectors are tensors here; this
    constructor exists for API parity (cusp/array1d.h:98)."""
    return torch.full((n,), fill, dtype=dtype, device=resolve_device(device))


def array1d_view(a, start: int = 0, stop: Optional[int] = None,
                 stride: int = 1) -> torch.Tensor:
    """Subrange view of a vector (cusp::array1d_view, cusp/array1d.h:361):
    a torch view, so writes reach `a`."""
    return a[start:stop:stride]
