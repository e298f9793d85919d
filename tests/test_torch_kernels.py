"""The port's SpMV kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version, which is
held here against the Pallas kernel run in interpret mode, at the
reference's own tolerances (tests/test_pallas.py:22 and :97).  The CUDA
kernels themselves are held against their plain versions on the card by
tests/test_torch_cuda.py and by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.backend.reference import from_scipy as jax_from_scipy
from cusp_autotuned_tpu.kernels.pallas_csr import build_csr_onehot
from cusp_autotuned_tpu.kernels.pallas_dia import build_dia as jax_build_dia

from cusp_autotuned_tpu_torch import gallery
from cusp_autotuned_tpu_torch.kernels import build_spmv, default_config
from cusp_autotuned_tpu_torch.kernels.csr import build_csr
from cusp_autotuned_tpu_torch.kernels.dia import build_dia
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)

from tests.torch_parity import banded, one_thread, port_of, skewed_random  # noqa: F401

DIA_SHAPES = {
    # the five DIA shapes of tests/test_pallas.py:25-51, with seeded values
    "poisson": lambda: jgallery.poisson5pt(37, 41, format="dia", dtype=np.float32),
    "lane_aligned": lambda: jax_from_scipy(
        banded(1500, 1500, [-256, -128, 0, 128, 384], 0), "dia", dtype=np.float32),
    "unaligned": lambda: jax_from_scipy(
        banded(1500, 1500, [-1000, -3, 0, 5, 999], 1), "dia", dtype=np.float32),
    "rect_wide": lambda: jax_from_scipy(
        banded(300, 520, [0, 150, 320], 2), "dia", dtype=np.float32),
    "rect_tall": lambda: jax_from_scipy(
        banded(520, 300, [-220, 0], 3), "dia", dtype=np.float32),
}


def _x(n, seed=3):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.mark.parametrize("value_dtype", ["none", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(DIA_SHAPES))
def test_dia_plain_matches_pallas(shape, value_dtype):
    J = DIA_SHAPES[shape]()
    x = _x(J.num_cols)
    ref = np.asarray(jax.jit(jax_build_dia(
        J, {"block_rows": 1024, "value_dtype": value_dtype}, interpret=True))(
            jnp.asarray(x)))
    fn = build_dia(port_of(J), {"value_dtype": value_dtype})
    assert fn.planned_arrays["data"].dtype == (
        torch.bfloat16 if value_dtype == "bfloat16" else torch.float32)
    y = fn(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (J.num_rows,)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-4)


CSR_MATRICES = {
    "poisson": lambda: jgallery.poisson5pt(37, 41, format="csr", dtype=np.float32),
    "random_2000": lambda: jax_from_scipy(skewed_random(2000, 7), "csr",
                                          dtype=np.float32),
}


@functools.cache
def _onehot_case(name):
    """(JAX matrix, x, Pallas one-hot y): one interpret run per matrix."""
    J = CSR_MATRICES[name]()
    x = _x(J.num_cols, seed=5)
    y = np.asarray(jax.jit(build_csr_onehot(J, {}, interpret=True))(jnp.asarray(x)))
    return J, x, y


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("name", sorted(CSR_MATRICES))
def test_csr_plain_matches_pallas(name, fmt):
    J, x, ref = _onehot_case(name)
    P = port_of(J)
    if fmt == "coo":
        from cusp_autotuned_tpu_torch.ops.convert import convert
        P = convert(P, "coo")                  # the builder converts it back
    y = build_csr(P, {})(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["dia", "csr", "coo"])
def test_cuda_impl_rejects_2d_x(fmt):
    """The CSR kernel (csr/coo `cuda`) takes vectors only, as the JAX
    package's `pallas` impl does; the DIA kernels take a 2-D x (the SpMM
    kernel) and reject a rank above it."""
    A = gallery.poisson5pt(6, 5, format=fmt, device="cpu")
    fn = build_spmv(A, {"impl": "cuda"})
    x = torch.ones(A.num_cols, 2)
    if fmt == "dia":
        assert fn(x).shape == (A.num_rows, 2)
        x = x[..., None]
    with pytest.raises(NotImplementedException):
        fn(x)


@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_wrapper_raises_off_the_cpu_instead_of_falling_back(fmt):
    """Tensors that are not all on the CPU must reach the kernel or raise;
    a meta tensor is neither CPU nor CUDA."""
    A = gallery.poisson5pt(6, 5, format=fmt, device="cpu")
    fn = build_spmv(A, {"impl": "cuda"})
    with pytest.raises(InvalidInputException):
        fn(torch.ones(A.num_cols, device="meta"))


@pytest.mark.parametrize("fmt,plain", [("dia", "slices"), ("csr", "segsum"),
                                       ("coo", "segsum")])
def test_default_config_on_cpu_is_the_plain_path(fmt, plain):
    A = gallery.poisson5pt(6, 5, format=fmt, device="cpu")
    assert default_config(A)["impl"] == plain
