"""Matrix gallery (counterpart of cusp_autotuned_tpu/gallery; the stencil
generator, the 2-D Poisson matrices, random matrices and the fork's KTT
diagonal generators are ported so far).  Every generator builds on the
CUDA device unless the caller names another."""

from cusp_autotuned_tpu_torch.gallery.poisson import poisson5pt, poisson9pt
from cusp_autotuned_tpu_torch.gallery.random import random
from cusp_autotuned_tpu_torch.gallery.stencil import generate_matrix_from_stencil
from cusp_autotuned_tpu_torch.gallery.generators import (
    make_diagonal_matrix, make_diagonal_symmetric_matrix,
)
