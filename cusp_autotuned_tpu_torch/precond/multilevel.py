"""Generic multilevel (V-cycle) hierarchy (counterpart of
cusp_autotuned_tpu/precond/multilevel.py).

Parity: cusp/detail/multilevel.{h,inl}: per-level {R, A, P, smoother}
(multilevel.h:112-129), min_level_size = 500 and max_levels = 10
(:142), the coarsest solve by a dense direct method (cusp/detail/lu.h),
operator() = one V-cycle from a zero guess, so that the hierarchy serves as
a Krylov preconditioner (multilevel.inl:139-140), a standalone solve()
loop (:156-165), the recursive pre-smooth, restrict, recurse, correct,
post-smooth (:180-225) and the print() report (:227+).

The JAX package unrolls the V-cycle into one compiled program.  Here it
runs as plain launches from the host, a few PyTorch ops and one SpMV or
operator apply at a time; nothing in it reads the device back.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor, default_monitor

MIN_LEVEL_SIZE = 500
MAX_LEVELS = 10


@dataclasses.dataclass(frozen=True)
class Level:
    R: Any            # restriction (container)
    A: Any            # level operator (container: set-up and reports)
    P: Any            # prolongation (container)
    smoother: Any     # presmooth/postsmooth adapter
    Aop: Any = None   # planned apply operators; the V-cycle and the
    Rop: Any = None   # smoothers multiply through them where set,
    Pop: Any = None   # else through the containers

    @property
    def apply_op(self):
        return self.Aop if self.Aop is not None else self.A

    @property
    def restrict_op(self):
        return self.Rop if self.Rop is not None else self.R

    @property
    def prolong_op(self):
        return self.Pop if self.Pop is not None else self.P


@dataclasses.dataclass(frozen=True)
class CoarseLU:
    """The coarsest level's direct solve.  The reference factors a dense LU
    and back-substitutes (cusp/detail/lu.h:81-152); like the JAX package,
    the port inverts the coarse matrix once at set-up, in f64 on the host,
    and applies the inverse as one dense product a cycle."""
    inv: torch.Tensor

    @property
    def n(self) -> int:
        return self.inv.shape[0]

    def __call__(self, b):
        return torch.matmul(self.inv, b)


@dataclasses.dataclass(frozen=True)
class Multilevel:
    levels: Tuple[Level, ...]
    coarse: CoarseLU
    shape: Tuple[int, int] = (0, 0)
    # set-up seconds by stage, summed over the levels (smoothed_aggregation)
    setup_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    format = "multilevel"

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    # -- V-cycle ------------------------------------------------------------

    def _cycle(self, i: int, b):
        if i == len(self.levels):
            return self.coarse(b)
        lvl = self.levels[i]
        op = lvl.apply_op
        x = lvl.smoother.presmooth(op, b)
        r = b - multiply(op, x, use_autotuning=False)
        rc = multiply(lvl.restrict_op, r, use_autotuning=False)
        ec = self._cycle(i + 1, rc)
        x = x + multiply(lvl.prolong_op, ec, use_autotuning=False)
        return lvl.smoother.postsmooth(op, b, x)

    def __call__(self, b):
        """One V-cycle from a zero initial guess (M in a Krylov solver)."""
        return self._cycle(0, torch.as_tensor(b))

    # -- standalone solve -----------------------------------------------------

    def solve(self, b, x0=None, monitor: Monitor | None = None):
        """Repeat x <- x + V(r), r = b - A x, until the monitor stops: one
        top-level SpMV an iteration beside the cycle."""
        b = torch.as_tensor(b)
        x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).clone()
        if monitor is None:
            monitor = default_monitor(b)
        A = self.levels[0].apply_op
        r = b - multiply(A, x, use_autotuning=False)
        while not monitor.finished(r):
            x = x + self(r)
            r = b - multiply(A, x, use_autotuning=False)
        return x, monitor

    # -- reporting --------------------------------------------------------------

    def operator_complexity(self) -> float:
        nnz = [lvl.A.num_entries for lvl in self.levels]
        nnz.append(self.coarse.n ** 2)
        return float(sum(nnz)) / max(1, self.levels[0].A.num_entries)

    def grid_complexity(self) -> float:
        rows = [lvl.A.num_rows for lvl in self.levels]
        rows.append(self.coarse.n)
        return float(sum(rows)) / max(1, self.levels[0].A.num_rows)

    def print(self, stream=None) -> None:
        stream = stream or sys.stdout
        stream.write(f"multilevel hierarchy: {len(self.levels) + 1} levels\n")
        stream.write(f"  operator complexity: {self.operator_complexity():.3f}\n")
        stream.write(f"  grid complexity:     {self.grid_complexity():.3f}\n")
        stream.write("  level       rows        entries\n")
        for i, lvl in enumerate(self.levels):
            stream.write(f"  {i:>5} {lvl.A.num_rows:>10} {lvl.A.num_entries:>14}\n")
        n = self.coarse.n
        stream.write(f"  {len(self.levels):>5} {n:>10} {n * n:>14} (dense LU)\n")


def coarse_lu(dense: np.ndarray, dtype: torch.dtype, device) -> CoarseLU:
    """The coarse solve of a dense host matrix: its f64 inverse in `dtype`."""
    inv = np.linalg.inv(np.asarray(dense, dtype=np.float64))
    return CoarseLU(inv=torch.from_numpy(inv).to(device=device, dtype=dtype))
