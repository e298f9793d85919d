"""The port's eigensolvers against the JAX package's, on the CPU.

Both packages run on tests/test_eigen.py's matrix, poisson5pt(10, 10) in
f64, from the same seeded start vectors and with the same iteration limits.
Eigenvalues and estimates agree to 1e-8 relative, vectors to 1e-6 up to
sign: the two packages take the same steps and differ only in rounding."""

import functools
import importlib

import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import eigen as jeigen, gallery as jgallery

from cusp_autotuned_tpu_torch import eigen
from cusp_autotuned_tpu_torch.operators import FunctionOperator, planned_operator
from cusp_autotuned_tpu_torch.ops.multiply import multiply

from tests.torch_parity import one_thread, port_of  # noqa: F401

RTOL = 1e-8
# the module, which the package's `lobpcg` function shadows
lobpcg_mod = importlib.import_module("cusp_autotuned_tpu_torch.eigen.lobpcg")


@functools.cache
def _matrices():
    J = jgallery.poisson5pt(10, 10, format="csr", dtype=np.float64)
    return J, port_of(J)


def _same_up_to_sign(a, b, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    sign = 1.0 if np.dot(a.ravel(), b.ravel()) >= 0 else -1.0
    np.testing.assert_allclose(a, sign * b, rtol=0, atol=atol)


def test_gram_schmidt_matches_jax():
    V = np.random.RandomState(0).randn(40, 6)
    Q = eigen.gram_schmidt(torch.from_numpy(V))
    assert Q.is_contiguous()
    np.testing.assert_allclose(Q.numpy(), np.asarray(jeigen.gram_schmidt(V)),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(Q.T.numpy() @ Q.numpy(), np.eye(6), atol=1e-10)


@pytest.mark.parametrize("largest,maxiter", [(True, 200), (False, 300)])
def test_lobpcg_matches_jax(largest, maxiter):
    J, A = _matrices()
    lam_j, x_j = jeigen.lobpcg(J, largest=largest, maxiter=maxiter, tol=1e-8)
    lam, x, its = eigen.lobpcg(A, largest=largest, maxiter=maxiter, tol=1e-8,
                               return_iterations=True)
    assert lam.dtype == torch.float64 and 0 < its <= maxiter
    assert float(lam) == pytest.approx(float(lam_j), rel=RTOL)
    _same_up_to_sign(x.numpy(), x_j)


def test_lobpcg_applies_the_operator_to_its_block_once_a_step(monkeypatch):
    """Each step applies the operator to two vectors (A x, the Rayleigh
    quotient) and to one (n, 3) block, the masked steps after the stop
    too; the stop flag read once per block of steps gives the per-step
    loop's eigenpair and count."""
    _, A = _matrices()
    shapes = []

    def apply(x):
        shapes.append(tuple(x.shape))
        return multiply(A, x)

    op = FunctionOperator(fn=apply, shape=A.shape, dtype=A.dtype, device=A.device)
    lam, x, its = eigen.lobpcg(op, maxiter=200, tol=1e-8, return_iterations=True)
    block = lobpcg_mod.CHECK_EVERY
    assert shapes.count((100, 3)) == -(-its // block) * block
    assert shapes.count((100,)) == 2 * shapes.count((100, 3)) + 1
    monkeypatch.setattr(lobpcg_mod, "CHECK_EVERY", 1)
    lam1, x1, its1 = eigen.lobpcg(A, maxiter=200, tol=1e-8, return_iterations=True)
    assert its1 == its and float(lam1) == float(lam)
    assert torch.equal(x1, x)


def test_lobpcg_through_a_planned_operator():
    J, A = _matrices()
    lam_j, _ = jeigen.lobpcg(J, largest=True, maxiter=200, tol=1e-8)
    op = planned_operator(A, {"impl": "binned"})
    assert (op.num_rows, op.dtype) == (100, torch.float64)
    lam, _ = eigen.lobpcg(op, largest=True, maxiter=200, tol=1e-8)
    assert float(lam) == pytest.approx(float(lam_j), rel=RTOL)


def test_lanczos_matches_jax():
    J, A = _matrices()
    opts_j = jeigen.LanczosOptions(iteration_limit=60, num_eigvals=3, which="LA")
    opts = eigen.LanczosOptions(iteration_limit=60, num_eigvals=3, which="LA")
    np.testing.assert_allclose(eigen.lanczos(A, opts).numpy(),
                               np.asarray(jeigen.lanczos(J, opts_j)), rtol=RTOL)
    vals_j, vecs_j = jeigen.lanczos(J, opts_j, return_eigvecs=True)
    vals, vecs = eigen.lanczos(A, opts, return_eigvecs=True)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), rtol=RTOL)
    # the largest eigenvalue is simple; the next two are a double one, whose
    # vectors any basis of the eigenspace may give
    _same_up_to_sign(vecs[:, 0].numpy(), np.asarray(vecs_j)[:, 0])
    S = A.to_scipy().toarray()
    for lam, v in zip(vals.numpy(), vecs.numpy().T):
        assert np.linalg.norm(S @ v - lam * v) < 1e-5
    small = eigen.lanczos(A, eigen.LanczosOptions(iteration_limit=60, which="SA"))
    assert float(small[0]) == pytest.approx(float(np.linalg.eigvalsh(S)[0]), rel=1e-6)


def test_arnoldi_matches_jax():
    J, A = _matrices()
    H = eigen.arnoldi(A, k=30)
    H_j = np.asarray(jeigen.arnoldi(J, k=30))
    assert H.shape == H_j.shape
    np.testing.assert_allclose(H.numpy(), H_j, rtol=0, atol=1e-6)
    top = np.max(np.linalg.eigvals(H.numpy()[:-1, :]).real)
    assert top == pytest.approx(np.max(np.linalg.eigvals(H_j[:-1, :]).real), rel=RTOL)


@pytest.mark.parametrize("estimate", ["disks", "power", "ritz", "ritz_arnoldi"])
def test_spectral_radius_matches_jax(estimate):
    J, A = _matrices()
    calls = {
        "disks": lambda m, e: e.disks_spectral_radius(m),
        "power": lambda m, e: e.estimate_spectral_radius(m, k=50),
        "ritz": lambda m, e: e.ritz_spectral_radius(m, k=20),
        "ritz_arnoldi": lambda m, e: e.ritz_spectral_radius(m, k=20, symmetric=False),
    }[estimate]
    got, want = calls(A, eigen), calls(J, jeigen)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=RTOL)
