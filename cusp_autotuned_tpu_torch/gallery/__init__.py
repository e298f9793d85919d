"""Matrix gallery (counterpart of cusp_autotuned_tpu/gallery: the stencil
generator, the 2-D and 3-D Poisson matrices, grid graphs, the rotated
anisotropic diffusion operators, random matrices, the fork's KTT diagonal
generators and the Williams/Bell-Garland suite stand-ins).  Every
generator of a container builds on the CUDA device unless the caller names
another; williams_suite returns scipy matrices."""

from cusp_autotuned_tpu_torch.gallery.poisson import (
    poisson5pt, poisson9pt, poisson7pt, poisson27pt,
)
from cusp_autotuned_tpu_torch.gallery.grid import grid2d, grid3d
from cusp_autotuned_tpu_torch.gallery.diffusion import diffusion, FE, FD
from cusp_autotuned_tpu_torch.gallery.random import random
from cusp_autotuned_tpu_torch.gallery.stencil import generate_matrix_from_stencil
from cusp_autotuned_tpu_torch.gallery.generators import (
    make_diagonal_matrix, make_diagonal_symmetric_matrix,
)
from cusp_autotuned_tpu_torch.gallery.suite import stencil_suite, williams_suite
