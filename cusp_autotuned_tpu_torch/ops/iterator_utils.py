"""Array builders standing in for the reference's fancy iterators
(counterpart of cusp_autotuned_tpu/ops/iterator_utils.py; parity target
cusp/iterator/ — join_iterator (join_iterator.h:141), strided_iterator
(strided_iterator.h:78), random_iterator (random_iterator.h:81), and the
counting/constant arrays of cusp/array1d.h).

Each materialises its sequence as a tensor on `device`, by default the
CUDA device."""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.utils.config import resolve_device


def counting_array(n: int, start: int = 0, dtype=torch.int32, device=None):
    """cusp::counting_array — [start, start+1, ...)."""
    return torch.arange(start, start + n, dtype=dtype, device=resolve_device(device))


def constant_array(n: int, value, dtype=None, device=None):
    """cusp::constant_array — n copies of value."""
    return torch.full((n,), value, dtype=dtype, device=resolve_device(device))


def join(*arrays):
    """join_iterator — several tensors as one concatenated sequence."""
    return torch.cat([torch.as_tensor(a) for a in arrays])


def strided(array, stride: int, start: int = 0):
    """strided_iterator — every `stride`-th element."""
    return array[start::stride]


def strided_range(n: int, stride: int, dtype=torch.int32, device=None):
    """The reference's strided counting idiom: 0, s, 2s, ... below n."""
    return torch.arange(0, n, stride, dtype=dtype, device=resolve_device(device))


def random_array(n: int, seed: int = 0, dtype=torch.float32, device=None):
    """random_iterator — a pseudorandom sequence drawn from a
    torch.Generator seeded with `seed`: the same seed gives the same
    sequence on every device (it is drawn on the host and copied).
    Uniform in [0, 1) for floats, the type's full range for integers."""
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        out = torch.rand(n, generator=gen, dtype=dtype)
    else:
        info = torch.iinfo(dtype)
        out = torch.randint(info.min, info.max, (n,), generator=gen, dtype=dtype)
    return out.to(resolve_device(device))
