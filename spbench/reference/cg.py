"""Textbook conjugate gradients (Hestenes and Stiefel) from x0 = 0, every
vector and scalar in `dtype`, with a monitor's stopping rule: stop once the
(recursively updated) residual's norm is at most relative_tolerance *
||b||, or after iteration_limit iterations."""

from __future__ import annotations

import torch


def cg(apply, b, iteration_limit: int, dtype, relative_tolerance: float = 0.0):
    """(x, iterations) of CG on A x = b, A applied by apply(v) -> A v in
    `dtype`; iterations is the count at which the rule stopped it."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    tolerance = relative_tolerance * float(torch.sqrt(rr))
    iterations = 0
    while iterations < iteration_limit and float(torch.sqrt(rr)) > tolerance:
        ap = apply(p)
        alpha = rr / torch.dot(p, ap)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        iterations += 1
    return x, iterations
