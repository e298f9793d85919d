"""Container base machinery (counterpart of cusp_autotuned_tpu/formats/base.py).

Containers are frozen dataclasses of tensors.  `shape` and `nnz` are plain
Python metadata; every tensor field moves with `.to(device)`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class MatrixBase:
    """Common interface: num_rows / num_cols / num_entries (parity with
    cusp/detail/matrix_base.h), dtype and device."""

    format: str = "unknown"

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def num_entries(self) -> int:
        return self.nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "MatrixBase":
        """The same matrix with every tensor field on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)

    def to_scipy(self):
        from cusp_autotuned_tpu_torch.backend.reference import to_scipy
        return to_scipy(self)

    def __matmul__(self, other):
        from cusp_autotuned_tpu_torch.ops.multiply import multiply
        return multiply(self, other)

    def __call__(self, x):
        """Containers are linear operators (parity: cusp/linear_operator.h)."""
        from cusp_autotuned_tpu_torch.ops.multiply import multiply
        return multiply(self, x)


def host_array(a) -> np.ndarray:
    """A tensor or array-like as a host numpy array (bf16 widened to f32,
    which numpy cannot hold)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """a as a tensor: a tensor stays on its device unless `device` names
    another; host data goes to `device`, by default the CUDA device."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=dtype or a.dtype)
    from cusp_autotuned_tpu_torch.utils.config import resolve_device
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(device))


def index_tensor(a, device) -> torch.Tensor:
    """Host indices as a new int32 tensor (never a view of the caller's array)."""
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def value_tensor(a, dtype, device) -> torch.Tensor:
    """Host values as a new tensor of `dtype` (None keeps the array's own)."""
    t = torch.tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)
