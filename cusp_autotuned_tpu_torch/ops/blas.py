"""Dense BLAS verbs (counterpart of cusp_autotuned_tpu/ops/blas.py; parity
target cusp/blas/blas.h and cusp/detail/blas.inl:34-935 — amax asum axpy
axpby axpbypcz xmy copy fill dot dotc nrm1 nrm2 nrmmax scal gemv ger symv
syr trmv trsv gemm symm syrk trmm trsm).

Functional, as in the JAX package: a routine returns its result instead of
writing an output argument.  Results stay on the operands' device (a
reduction as a 0-d tensor), so a solver loop reads nothing back.  A
non-tensor operand is taken onto the device of the call's first tensor,
else built on the CUDA device.
"""

from __future__ import annotations

import torch

from cusp_autotuned_tpu_torch.utils.config import resolve_device


def _tensors(*xs):
    """The operands as tensors on one device: that of the first tensor
    among them, else the CUDA device."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    device = device if device is not None else resolve_device()
    return [x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=device)
            for x in xs]


def _matmul(A, B):
    """A @ B in the promoted type of the two."""
    dtype = torch.promote_types(A.dtype, B.dtype)
    return torch.matmul(A.to(dtype), B.to(dtype))


def amax(x):
    """Index of the entry with largest absolute value."""
    (x,) = _tensors(x)
    return torch.argmax(torch.abs(x))


def asum(x):
    (x,) = _tensors(x)
    return torch.sum(torch.abs(x))


def axpy(x, y, alpha=1.0):
    """alpha*x + y."""
    return alpha * x + y


def axpby(x, y, alpha, beta):
    return alpha * x + beta * y


def axpbypcz(x, y, z, alpha, beta, gamma):
    x, y, z = _tensors(x, y, z)
    return alpha * x + beta * y + gamma * z


def xmy(x, y):
    """Elementwise x * y."""
    x, y = _tensors(x, y)
    return x * y


def copy(x):
    (x,) = _tensors(x)
    return x.clone()


def fill(n_or_like, value, device=None):
    """blas::fill — a constant vector: shaped like a tensor, or of length n
    on `device` (by default the CUDA device)."""
    if isinstance(n_or_like, torch.Tensor):
        return torch.full_like(n_or_like, value)
    if hasattr(n_or_like, "shape"):
        return torch.full_like(torch.as_tensor(n_or_like, device=resolve_device(device)),
                               value)
    return torch.full((int(n_or_like),), value, device=resolve_device(device))


def dot(x, y):
    """sum(x * y), unconjugated."""
    x, y = _tensors(x, y)
    return torch.sum(x * y)


def dotc(x, y):
    """Conjugated dot product <x, y> = sum(conj(x) * y), spelled as the JAX
    package spells it: in f32 the sum's order shows in a CG history, and
    this order keeps the port's history within 1e-4 of the reference's."""
    return torch.sum(torch.conj(x) * y)


def nrm1(x):
    (x,) = _tensors(x)
    return torch.sum(torch.abs(x))


def nrm2(x):
    (x,) = _tensors(x)
    return torch.linalg.vector_norm(x)


def nrmmax(x):
    (x,) = _tensors(x)
    return torch.max(torch.abs(x))


def scal(x, alpha):
    (x,) = _tensors(x)
    return alpha * x


# -- level 2 ------------------------------------------------------------------

def gemv(A, x, alpha=1.0, beta=0.0, y=None):
    """alpha A x (+ beta y)."""
    A, x = _tensors(A, x)
    r = alpha * _matmul(A, x)
    return r if y is None or beta == 0.0 else r + beta * _tensors(y, A)[0]


def ger(x, y, A=None, alpha=1.0):
    """Rank-1 update alpha x y^T (+ A)."""
    x, y = _tensors(x, y)
    r = alpha * torch.outer(x, y)
    return r if A is None else r + _tensors(A, x)[0]


def symv(A, x, alpha=1.0, beta=0.0, y=None):
    return gemv(A, x, alpha, beta, y)


def syr(x, A=None, alpha=1.0):
    return ger(x, x, A, alpha)


def trmv(A, x):
    """A x (A's triangle stored in full, as in the JAX package)."""
    A, x = _tensors(A, x)
    return _matmul(A, x)


def _solve_triangular(A, b, lower, unit_diagonal):
    A, b = _tensors(A, b)
    dtype = torch.promote_types(A.dtype, b.dtype)
    rhs = b.to(dtype)
    x = torch.linalg.solve_triangular(A.to(dtype), rhs[:, None] if b.dim() == 1 else rhs,
                                      upper=not lower, unitriangular=unit_diagonal)
    return x[:, 0] if b.dim() == 1 else x


def trsv(A, b, lower=False, unit_diagonal=False):
    return _solve_triangular(A, b, lower, unit_diagonal)


# -- level 3 ------------------------------------------------------------------

def gemm(A, B, alpha=1.0, beta=0.0, C=None):
    """alpha A B (+ beta C)."""
    A, B = _tensors(A, B)
    r = alpha * _matmul(A, B)
    return r if C is None or beta == 0.0 else r + beta * _tensors(C, A)[0]


def symm(A, B, alpha=1.0, beta=0.0, C=None):
    return gemm(A, B, alpha, beta, C)


def syrk(A, alpha=1.0, beta=0.0, C=None):
    """alpha A A^T (+ beta C), A^T unconjugated."""
    (A,) = _tensors(A)
    r = alpha * (A @ A.T)
    return r if C is None or beta == 0.0 else r + beta * _tensors(C, A)[0]


def trmm(A, B, alpha=1.0):
    A, B = _tensors(A, B)
    return alpha * _matmul(A, B)


def trsm(A, B, lower=False, unit_diagonal=False):
    return _solve_triangular(A, B, lower, unit_diagonal)
