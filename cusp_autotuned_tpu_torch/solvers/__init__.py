"""Krylov solvers and the convergence monitor (counterpart of
cusp_autotuned_tpu/solvers; CG is ported so far)."""

from cusp_autotuned_tpu_torch.solvers.monitor import (
    Monitor, MonitorState, default_monitor, monitor_init,
)
from cusp_autotuned_tpu_torch.solvers.cg import cg
