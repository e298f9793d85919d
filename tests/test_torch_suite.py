"""The port's Williams/Bell-Garland suite stand-ins and 3-D Poisson
matrices against the JAX package's, on the CPU: the same numpy seeds give
the same scipy matrices, entry by entry, and the Laplacian stencils the
same containers once both are converted to scipy."""

import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.gallery.suite import (
    stencil_suite as jax_stencil_suite, williams_suite as jax_williams_suite,
)

from cusp_autotuned_tpu_torch import gallery
from cusp_autotuned_tpu_torch.backend.reference import to_scipy
from cusp_autotuned_tpu_torch.gallery.suite import SCATTERED
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException


def _same_csr(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def test_williams_suite_matches_jax_entry_by_entry():
    ref, port = jax_williams_suite(0.05), gallery.williams_suite(0.05)
    assert list(port) == list(ref) and len(port) == 14
    for name in ref:
        assert _same_csr(port[name], ref[name]), name
    # a subset holds the same matrices: each entry draws from its own seed
    sub = gallery.williams_suite(0.05, names=SCATTERED)
    assert list(sub) == list(SCATTERED)
    for name in SCATTERED:
        assert _same_csr(sub[name], ref[name]), name
    with pytest.raises(KeyError):
        gallery.williams_suite(0.05, names=("Nothing",))


def test_stencil_suite_matches_jax():
    ref, port = jax_stencil_suite(0.01), gallery.stencil_suite(0.01, device="cpu")
    assert list(port) == list(ref)
    for name in ref:
        assert port[name].format == "dia" and port[name].device.type == "cpu"
        a, b = ref[name].to_scipy().tocsr(), to_scipy(port[name]).tocsr()
        a.sort_indices()
        b.sort_indices()
        assert _same_csr(b, a), name
    if not torch.cuda.is_available():
        with pytest.raises(InvalidInputException):
            gallery.stencil_suite(0.01)         # the card unless told the CPU


@pytest.mark.parametrize("name,grid", [("poisson7pt", (4, 3, 5)),
                                       ("poisson27pt", (3, 4, 2))])
@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_3d_poisson_matches_jax(name, grid, fmt):
    J = getattr(jgallery, name)(*grid, format=fmt)
    P = getattr(gallery, name)(*grid, format=fmt, device="cpu")
    a, b = J.to_scipy().tocsr(), to_scipy(P).tocsr()
    a.sort_indices()
    b.sort_indices()
    assert P.dtype == torch.float32 and _same_csr(b, a)
