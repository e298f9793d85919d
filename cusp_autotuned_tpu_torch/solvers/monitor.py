"""Convergence monitor (counterpart of cusp_autotuned_tpu/solvers/monitor.py;
parity target cusp::monitor, cusp/monitor.h).

MonitorState lives on the solve's device: the iteration count, the last
residual norm, ||b|| and the residual history preallocated to
iteration_limit + 1.  A solver records into it without reading anything
back, and reads its stop flag only now and then.  Monitor is the
host-facing object with the reference's API.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Tuple

import numpy as np
import torch

from cusp_autotuned_tpu_torch.ops import blas


@dataclasses.dataclass(frozen=True)
class MonitorState:
    k: torch.Tensor                    # iterations recorded so far (int64, 0-d)
    r_norm: torch.Tensor               # last residual norm (0-d)
    b_norm: torch.Tensor               # ||b|| (0-d)
    residuals: torch.Tensor            # (limit + 1,) history, NaN-filled
    relative_tolerance: float = 1e-5
    absolute_tolerance: float = 0.0
    iteration_limit: int = 500

    @property
    def tolerance(self):
        return self.absolute_tolerance + self.relative_tolerance * self.b_norm

    def converged(self):
        return self.r_norm <= self.tolerance

    def keep_going(self):
        return torch.logical_and(torch.logical_not(self.converged()),
                                 self.k < self.iteration_limit)

    def record_(self, r_norm, active=None) -> None:
        """Append one residual norm, in place, where the device flag
        `active` is set (always without one); a stopped solve records
        nothing."""
        if active is None:
            active = torch.ones((), dtype=torch.bool, device=self.k.device)
        self.k.add_(active.to(self.k.dtype))
        self.r_norm.copy_(torch.where(active, r_norm, self.r_norm))
        self.residuals.index_copy_(0, self.k.view(1),
                                   self.r_norm.view(1).to(self.residuals.dtype))


def monitor_init(b, iteration_limit=500, relative_tolerance=1e-5,
                 absolute_tolerance=0.0) -> MonitorState:
    b_norm = blas.nrm2(b)
    return MonitorState(
        k=torch.tensor(-1, dtype=torch.int64, device=b.device),
        r_norm=torch.full((), float("inf"), dtype=b_norm.dtype, device=b.device),
        b_norm=b_norm,
        residuals=torch.full((iteration_limit + 1,), float("nan"),
                             dtype=b_norm.dtype, device=b.device),
        relative_tolerance=float(relative_tolerance),
        absolute_tolerance=float(absolute_tolerance),
        iteration_limit=int(iteration_limit),
    )


def monitor_record(state: MonitorState, r_norm) -> MonitorState:
    """Append one residual norm to a new state, leaving `state` as it was
    (the JAX package's state-passing form; the solvers here record in
    place with MonitorState.record_)."""
    out = dataclasses.replace(state, k=state.k.clone(), r_norm=state.r_norm.clone(),
                              residuals=state.residuals.clone())
    out.record_(torch.as_tensor(r_norm, dtype=state.r_norm.dtype,
                                device=state.k.device))
    return out


class Monitor:
    """Host-facing monitor with the reference's API (cusp/monitor.h)."""

    def __init__(self, b, iteration_limit: int = 500,
                 relative_tolerance: float = 1e-5,
                 absolute_tolerance: float = 0.0,
                 verbose: bool = False):
        self._iteration_limit = int(iteration_limit)
        self._relative_tolerance = float(relative_tolerance)
        self._absolute_tolerance = float(absolute_tolerance)
        self.verbose = bool(verbose)
        self.reset(b)

    # -- configuration ------------------------------------------------------

    def iteration_limit(self) -> int:
        return self._iteration_limit

    def relative_tolerance(self) -> float:
        return self._relative_tolerance

    def absolute_tolerance(self) -> float:
        return self._absolute_tolerance

    def tolerance(self) -> float:
        return self._absolute_tolerance + self._relative_tolerance * self.b_norm

    @property
    def b_norm(self) -> float:
        if self._b_norm is None:
            self._b_norm = float(blas.nrm2(torch.as_tensor(self._b_ref)))
        return self._b_norm

    def spec(self) -> Tuple[int, float, float]:
        """(iteration_limit, rtol, atol)."""
        return (self._iteration_limit, self._relative_tolerance,
                self._absolute_tolerance)

    # -- driving (eager use) --------------------------------------------------

    def reset(self, b) -> None:
        # ||b|| is computed when first needed: a solver computes it on the
        # device and hands it back through absorb_state
        self._b_ref = b
        self._b_norm: float | None = None
        self.residuals: list = []
        if self.verbose:
            print(f"Solver will continue until residual norm {self.tolerance():.6g}"
                  f" or reaching {self._iteration_limit} iterations")
            print("  Iteration Number  | Residual Norm")

    def finished(self, r) -> bool:
        """Record ||r|| and report whether iteration should stop."""
        r_norm = float(blas.nrm2(torch.as_tensor(r)))
        self.residuals.append(r_norm)
        if self.verbose:
            print(f"  {self.iteration_count():10d}        {r_norm:14.6e}")
            if self.converged():
                print(f"Successfully converged after {self.iteration_count()}"
                      " iterations.")
            elif self.iteration_count() >= self._iteration_limit:
                print(f"Failed to converge after {self.iteration_count()}"
                      " iterations.")
        return self.converged() or self.iteration_count() >= self._iteration_limit

    def __iadd__(self, n: int):
        # parity with `++monitor`; the history length already counts iterations
        return self

    # -- results ----------------------------------------------------------------

    def iteration_count(self) -> int:
        return max(0, len(self.residuals) - 1)

    def residual_norm(self) -> float:
        return self.residuals[-1] if self.residuals else float("inf")

    def converged(self) -> bool:
        return self.residuals != [] and self.residual_norm() <= self.tolerance()

    def immediate_rate(self) -> float:
        r = self.residuals
        return r[-1] / r[-2] if len(r) >= 2 else float("nan")

    def geometric_rate(self) -> float:
        r = self.residuals
        if len(r) < 2 or r[0] == 0:
            return float("nan")
        return (r[-1] / r[0]) ** (1.0 / (len(r) - 1))

    def average_rate(self) -> float:
        r = self.residuals
        if len(r) < 2:
            return float("nan")
        rates = [b / a for a, b in zip(r[:-1], r[1:]) if a != 0]
        return float(np.mean(rates)) if rates else float("nan")

    def print(self, stream=None) -> None:
        stream = stream or sys.stdout
        stream.write(f"monitor: {self.iteration_count()} iterations, "
                     f"residual {self.residual_norm():.6e} "
                     f"(tolerance {self.tolerance():.6e}), "
                     f"{'converged' if self.converged() else 'not converged'}\n")
        if self.iteration_count() >= 1:
            stream.write(f"  immediate rate: {self.immediate_rate():.6f}\n")
            stream.write(f"  geometric rate: {self.geometric_rate():.6f}\n")
            stream.write(f"  average rate:   {self.average_rate():.6f}\n")

    # -- glue to the solvers ----------------------------------------------------

    def to_state(self, b) -> MonitorState:
        return monitor_init(b, self._iteration_limit,
                            self._relative_tolerance, self._absolute_tolerance)

    def absorb_state(self, state: MonitorState) -> "Monitor":
        """Fill this monitor's history from a solver's final MonitorState."""
        k = int(state.k)
        self._b_norm = float(state.b_norm)
        self.residuals = state.residuals[: k + 1].cpu().tolist()
        if self.verbose:
            for i, v in enumerate(self.residuals):
                print(f"  {i:10d}        {v:14.6e}")
            if self.converged():
                print(f"Successfully converged after {self.iteration_count()}"
                      " iterations.")
            else:
                print(f"Failed to converge after {self.iteration_count()}"
                      " iterations.")
        return self


def default_monitor(b) -> Monitor:
    """The reference's default monitor (cusp/krylov/detail/cg.inl:151-166):
    500 iterations, relative tolerance 1e-5."""
    return Monitor(b, iteration_limit=500, relative_tolerance=1e-5)
