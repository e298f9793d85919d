"""Four faults of the port against the JAX package and the scipy oracle,
each held to its case on the CPU:

  A. a product is computed in torch.promote_types of the matrix's and x's
     dtypes, so a complex matrix times a real x stays complex;
  B. a complex matrix gets the plain default, and the kernels refuse
     complex values when they are built;
  C. the tuner validates complex outputs as complex, complex64 at the f32
     tolerance;
  D. preconditioned CG applies M only in the iterations it counts.

The oracle is scipy in complex128 or f64; the JAX package's CG gives the
iteration count of case D."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery, solvers as jsolvers
from cusp_autotuned_tpu.precond import smoothed_aggregation as jsmoothed_aggregation

from cusp_autotuned_tpu_torch import autotune, precond, solvers
from cusp_autotuned_tpu_torch.autotune import ResultStatus, Tuner
from cusp_autotuned_tpu_torch.autotune.cost_model import recommend_config
from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels import build_spmv, default_config
from cusp_autotuned_tpu_torch.kernels.csr import build_csr
from cusp_autotuned_tpu_torch.kernels.dia import build_dia
from cusp_autotuned_tpu_torch.ops.multiply import multiply
from cusp_autotuned_tpu_torch.utils.exceptions import NotImplementedException

from tests.torch_parity import one_thread, port_of  # noqa: F401


def _complex_random(n, density, seed, dtype):
    rng = np.random.RandomState(seed)
    S = sp.random(n, n, density=density, random_state=rng, format="csr")
    S.data = (S.data + 1j * rng.uniform(-1.0, 1.0, S.nnz)).astype(dtype)
    return S


@pytest.mark.parametrize("fmt", ["csr", "coo", "dia", "ell", "hyb"])
def test_a_complex_matrix_times_real_x_stays_complex(fmt):
    S = _complex_random(50, 0.1, 0, np.complex128)
    x = np.random.RandomState(1).randn(50)
    A = from_scipy(S, fmt, device="cpu")
    y = multiply(A, torch.from_numpy(x))
    assert y.dtype == torch.complex128
    want = S @ x
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("fmt", ["csr", "dia", "ell"])
def test_a_f64_matrix_times_f32_x_is_f64(fmt):
    A = port_of(jgallery.poisson5pt(12, 12, format=fmt, dtype=np.float64))
    x = np.random.RandomState(2).randn(A.num_cols).astype(np.float32)
    y = multiply(A, torch.from_numpy(x))
    assert y.dtype == torch.float64
    want = A.to_scipy() @ x.astype(np.float64)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-14, atol=1e-14)


def test_b_complex_matrix_takes_the_plain_default():
    n = 4000
    S = sp.diags([np.full(n - 1, -1.0 + 0.5j), np.full(n, 4.0 + 0.1j),
                  np.full(n - 1, -1.0 - 0.5j)], [-1, 0, 1],
                 shape=(n, n), format="csr").astype(np.complex64)
    A = from_scipy(S, "csr", device="cpu")
    assert recommend_config(A)[0] == default_config(A)
    autotune.reset_tuning(A)
    op = autotune.tuned_operator(A)
    x = np.random.RandomState(3).randn(n).astype(np.complex64)
    y = op(torch.from_numpy(x))
    want = S.astype(np.complex128) @ x.astype(np.complex128)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fmt,build", [("dia", build_dia), ("csr", build_csr)])
def test_b_kernels_refuse_complex_at_build_time(fmt, build):
    S = _complex_random(30, 0.1, 4, np.complex64) + sp.eye(30)
    A = from_scipy(S, fmt, device="cpu")
    with pytest.raises(NotImplementedException):
        build(A, {})
    with pytest.raises(NotImplementedException):
        build_spmv(A, {"impl": "cuda"})


def test_c_tuner_validates_complex_values_as_complex():
    S = _complex_random(200, 0.05, 5, np.complex64) + sp.eye(200, dtype=np.complex64)
    A = from_scipy(S, "csr", device="cpu")
    x = torch.from_numpy(np.random.RandomState(6).randn(200).astype(np.complex64))

    def exact(A_, x_):
        return S.astype(np.complex128) @ x_.numpy().astype(np.complex128)

    def real_part_only(A_, x_):
        return exact(A_, x_).real

    refused = (ResultStatus.CompilationFailed, ResultStatus.DeviceLimitsExceeded)
    true_walk = Tuner(measure=False).tune(A, x, reference_computation=exact)
    computed = [r for r in true_walk if r.status not in refused]
    assert computed and all(r.status == ResultStatus.Ok for r in computed)
    zeroed_walk = Tuner(measure=False).tune(A, x,
                                            reference_computation=real_part_only)
    assert not [r for r in zeroed_walk if r.status == ResultStatus.Ok]


def test_d_preconditioned_cg_applies_m_only_in_counted_iterations():
    J = jgallery.poisson5pt(32, 32, format="csr", dtype=np.float64)
    b = np.random.RandomState(7).rand(J.num_rows)
    _, jmon = jsolvers.cg(J, b, M=jsmoothed_aggregation(J))

    A = port_of(J)
    M = precond.smoothed_aggregation(A)
    calls = []

    def counted(r):
        calls.append(1)
        return M(r)

    _, mon = solvers.cg(A, torch.from_numpy(b), M=counted)
    assert mon.converged()
    assert mon.iteration_count() == jmon.iteration_count()
    assert len(calls) <= mon.iteration_count() + 2
