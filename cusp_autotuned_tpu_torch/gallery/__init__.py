"""Matrix gallery (counterpart of cusp_autotuned_tpu/gallery; the stencil
generator and the 2-D Poisson matrices are ported so far)."""

from cusp_autotuned_tpu_torch.gallery.poisson import poisson5pt, poisson9pt
from cusp_autotuned_tpu_torch.gallery.stencil import generate_matrix_from_stencil
