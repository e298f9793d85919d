"""Krylov solvers and the convergence monitor (counterpart of
cusp_autotuned_tpu/solvers): cg, cr, bicg, bicgstab, gmres, the
multi-shift cg_m and bicgstab_m, and mixed-precision refinement (refine,
mixed_precision_cg)."""

from cusp_autotuned_tpu_torch.solvers.monitor import (
    Monitor, MonitorState, default_monitor, monitor_init, monitor_record,
)
from cusp_autotuned_tpu_torch.solvers.cg import cg
from cusp_autotuned_tpu_torch.solvers.bicgstab import bicgstab
from cusp_autotuned_tpu_torch.solvers.bicg import bicg
from cusp_autotuned_tpu_torch.solvers.cr import cr
from cusp_autotuned_tpu_torch.solvers.gmres import gmres
from cusp_autotuned_tpu_torch.solvers.cg_m import cg_m
from cusp_autotuned_tpu_torch.solvers.bicgstab_m import bicgstab_m
from cusp_autotuned_tpu_torch.solvers.mixed import refine, mixed_precision_cg
