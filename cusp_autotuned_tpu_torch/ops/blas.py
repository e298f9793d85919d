"""Dense BLAS-1 verbs that the solvers use (counterpart of
cusp_autotuned_tpu/ops/blas.py; parity target cusp/blas/blas.h).  Results
stay on the device as 0-d tensors, so a solver loop reads nothing back."""

from __future__ import annotations

import torch


def axpy(x, y, alpha=1.0):
    """alpha*x + y."""
    return alpha * x + y


def axpby(x, y, alpha, beta):
    return alpha * x + beta * y


def dotc(x, y):
    """Conjugated dot product <x, y> = sum(conj(x) * y), spelled as the JAX
    package spells it: in f32 the sum's order shows in a CG history, and
    this order keeps the port's history within 1e-4 of the reference's."""
    return torch.sum(torch.conj(x) * y)


def nrm2(x):
    return torch.linalg.vector_norm(x)
