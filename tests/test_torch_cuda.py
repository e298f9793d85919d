"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA device.
The module imports neither JAX nor the JAX package, so that it also runs on
a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets up JAX.)  The tolerances are
the reference's own for its DIA and CSR kernels (tests/test_pallas.py:22
and :97)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch import gallery, solvers
from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels import default_config
from cusp_autotuned_tpu_torch.kernels.csr import build_csr, csr_spmv, csr_spmv_plain
from cusp_autotuned_tpu_torch.kernels.dia import build_dia, dia_spmv, dia_spmv_plain
from cusp_autotuned_tpu_torch.operators import planned_operator
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)

pytestmark = pytest.mark.cuda

TOL = {"dia": dict(rtol=1e-5, atol=1e-4), "csr": dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _skewed(n, seed):
    """A seeded scipy matrix whose row lengths follow a heavy-tailed law
    (1 to 64 entries a row), as tests/torch_parity.py builds for the parity
    tests; a GPU machine may not find the `tests` directory as a package."""
    rng = np.random.RandomState(seed)
    lengths = np.minimum(1 + rng.pareto(1.5, n).astype(np.int64), 64)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    return sp.csr_matrix((rng.uniform(-1.0, 1.0, indptr[-1]),
                          rng.randint(0, n, indptr[-1]), indptr), shape=(n, n))


def _x(n, device, dtype=torch.float32, seed=3):
    x = np.random.RandomState(seed).randn(n)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _dia_case(A, config, device):
    """(kernel y, plain y, launches of this call) for a DIA matrix A."""
    fn = build_dia(A, config)
    x = _x(A.num_cols, device, A.dtype if A.dtype == torch.float64 else torch.float32)
    before = dia_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    yp = dia_spmv_plain(fn.planned_arrays["data"], A.offsets, x, A.shape)
    return y, yp, dia_spmv.launches - before


def _csr_case(A, config, device):
    """(kernel y, plain y, launches of this call) for a CSR matrix A."""
    fn = build_csr(A, config)
    x = _x(A.num_cols, device, A.dtype if A.dtype == torch.float64 else torch.float32)
    before = csr_spmv.launches
    y = fn(x)
    torch.cuda.synchronize()
    a = fn.planned_arrays
    yp = csr_spmv_plain(a["row"], a["col"], a["val"], x, A.num_rows)
    return y, yp, csr_spmv.launches - before


@pytest.mark.parametrize("value_dtype", ["none", "bfloat16"])
def test_dia_kernel_matches_plain_on_card(cuda_device, value_dtype):
    A = gallery.poisson5pt(300, 200, format="dia", device=cuda_device)
    assert default_config(A)["impl"] == "cuda"
    y, yp, launches = _dia_case(A, {"value_dtype": value_dtype}, cuda_device)
    assert launches == 1
    torch.testing.assert_close(y, yp, **TOL["dia"])


@pytest.mark.parametrize("value_dtype", ["none", "bfloat16"])
def test_csr_kernel_matches_plain_on_card(cuda_device, value_dtype):
    A = from_scipy(_skewed(20000, 8), "csr", dtype=torch.float32,
                   device=cuda_device)
    assert default_config(A)["impl"] == "cuda"
    y, yp, launches = _csr_case(A, {"value_dtype": value_dtype}, cuda_device)
    assert launches == 1
    torch.testing.assert_close(y, yp, **TOL["csr"])


def test_csr_kernel_rectangular_with_empty_rows_on_card(cuda_device):
    S = sp.random(3000, 2000, density=0.001, random_state=np.random.RandomState(6))
    A = from_scipy(S, "csr", dtype=torch.float32, device=cuda_device)
    assert (np.diff(S.tocsr().indptr) == 0).any()
    y, yp, _ = _csr_case(A, {}, cuda_device)
    torch.testing.assert_close(y, yp, **TOL["csr"])


@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_f64_kernels_match_plain_on_card(cuda_device, fmt):
    A = gallery.poisson5pt(120, 90, format=fmt, dtype=torch.float64,
                           device=cuda_device)
    y, yp, launches = (_dia_case if fmt == "dia" else _csr_case)(A, {}, cuda_device)
    assert launches == 1 and y.dtype == torch.float64
    torch.testing.assert_close(y, yp, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt", ["dia", "csr", "coo"])
def test_kernel_wrappers_raise_on_card(cuda_device, fmt):
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    A = gallery.poisson5pt(20, 10, format=fmt, device=cuda_device)
    fn = planned_operator(A, {"impl": "cuda"})
    counter = dia_spmv if fmt == "dia" else csr_spmv
    before = counter.launches
    x = _x(A.num_cols, cuda_device)
    with pytest.raises(NotImplementedException):
        fn(torch.stack([x, x], 1))
    with pytest.raises(InvalidInputException):
        fn(x.double())
    with pytest.raises(InvalidInputException):
        fn(torch.stack([x, x], 1)[:, 0])                # not contiguous
    with pytest.raises(InvalidInputException):
        fn(x.cpu())
    assert counter.launches == before


def test_cg_kernel_operator_matches_plain_on_card(cuda_device):
    A = gallery.poisson5pt(64, 64, format="csr", device=cuda_device)
    b = torch.as_tensor(np.random.RandomState(0).rand(A.num_rows),
                        dtype=torch.float32, device=cuda_device)
    out = {}
    for dia_impl in ("cuda", "slices"):
        op = planned_operator(A, {"impl": "via_dia", "dia_impl": dia_impl})
        before = dia_spmv.launches
        x, mon = solvers.cg(op, b, monitor=Monitor(b, 2000, 1e-5))
        out[dia_impl] = (x, mon, dia_spmv.launches - before)
    (xk, mk, nk), (xp, mp, np_) = out["cuda"], out["slices"]
    assert mk.converged() and mp.converged()
    assert abs(mk.iteration_count() - mp.iteration_count()) <= 2
    assert nk >= mk.iteration_count() and np_ == 0
    torch.testing.assert_close(xk, xp, rtol=1e-3, atol=1e-3 * float(xp.abs().max()))
