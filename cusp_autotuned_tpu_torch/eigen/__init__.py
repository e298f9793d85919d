"""Eigensolvers (counterpart of cusp_autotuned_tpu/eigen; parity targets
cusp/eigen/: lanczos with lanczos_options, lobpcg, arnoldi, the
spectral-radius estimators and gram_schmidt)."""

from cusp_autotuned_tpu_torch.eigen.spectral_radius import (
    disks_spectral_radius, estimate_spectral_radius, ritz_spectral_radius,
)
from cusp_autotuned_tpu_torch.eigen.lanczos import lanczos, LanczosOptions
from cusp_autotuned_tpu_torch.eigen.arnoldi import arnoldi
from cusp_autotuned_tpu_torch.eigen.lobpcg import lobpcg
from cusp_autotuned_tpu_torch.eigen.gram_schmidt import gram_schmidt
