"""ops.transpose and mixed-precision refinement, against the JAX package on
the CPU.

transpose: every sparse format on the same seeded matrices, held to the
JAX package's transpose and to scipy's .T entry for entry, in the input's
format on its device; a tensor.

refine and mixed_precision_cg: tests/test_mixed.py:77-104's cases on both
packages.  The port plans the inner operator with bf16 values (on the CPU
the binned plan's plain version); the JAX package's refine hands a
container to its inner solver unplanned, at full precision, so the two
inner solves differ by the bf16 rounding and x agrees to the solve's own
tolerance, not bit for bit.  The bf16 binned product itself is held to the
JAX package's in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery, solvers as js
from cusp_autotuned_tpu.backend.reference import from_scipy as jfrom_scipy
from cusp_autotuned_tpu.operators import planned_operator as jplanned_operator
from cusp_autotuned_tpu.ops.transpose import transpose as jtranspose

from cusp_autotuned_tpu_torch import solvers, transpose
from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.operators import planned_operator

from tests.torch_parity import one_thread, port_of  # noqa: F401

CPU = torch.device("cpu")


def _matrices():
    rng = np.random.RandomState(7)
    rect = sp.random(50, 40, density=0.07, random_state=rng)
    band = sp.diags([rng.rand(36), rng.rand(37), rng.rand(36)], [-1, 0, 2],
                    shape=(37, 38))
    wide = np.zeros((10, 30))
    wide[3, :25] = np.arange(1, 26)
    wide[5, 4], wide[8, 29] = 2, -1
    return {"rand50x40": rect, "band37x38": band, "widerow": sp.coo_matrix(wide)}


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia", "ell", "ellr", "hyb"])
@pytest.mark.parametrize("name", ["rand50x40", "band37x38", "widerow"])
def test_transpose_matches_jax_and_scipy(fmt, name):
    S = _matrices()[name].astype(np.float32)
    J = jfrom_scipy(S.tocoo(), fmt)
    At = transpose(port_of(J))
    assert At.format == fmt and At.device == CPU and At.shape == S.T.shape
    got = At.to_scipy().toarray()
    np.testing.assert_array_equal(got, S.T.toarray())
    np.testing.assert_array_equal(got, jtranspose(J).to_scipy().toarray())
    x = np.random.RandomState(1).rand(S.shape[0]).astype(np.float32)
    np.testing.assert_allclose(At(torch.from_numpy(x)).numpy(), S.T @ x,
                               rtol=1e-6, atol=1e-6)
    assert transpose(At).to_scipy().toarray().tolist() == S.toarray().tolist()


def test_transpose_dia_keeps_diagonals_and_nnz():
    """A^T's diagonal -off holds A's diagonal off; nnz is A's."""
    S = _matrices()["band37x38"].astype(np.float64)
    A = from_scipy(S, "dia", device=CPU)
    At = transpose(A)
    assert At.offsets == (-2, 0, 1) and At.nnz == A.nnz
    assert At.data.shape == (3, 128) and At.data.dtype == torch.float64


def test_transpose_dense_and_refusal():
    a = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(transpose(a), a.T)
    with pytest.raises(TypeError):
        transpose(lambda x: x)


def test_refine_reaches_f32_accuracy():
    """tests/test_mixed.py:77: defect correction over the bf16 operator
    reaches rtol 1e-6, far below the bf16 operator's own rounding, in a few
    sweeps; x agrees with the JAX package's refine to the solve's
    tolerance times A's condition number (~260)."""
    J = jgallery.poisson5pt(24, 24, format="csr", dtype=np.float32)
    b = np.random.default_rng(3).standard_normal(J.num_rows).astype(np.float32)
    xj, mj = js.refine(J, jnp.asarray(b), config={"impl": "binned"}, inner_rtol=1e-3,
                       monitor=js.Monitor(jnp.asarray(b), iteration_limit=12,
                                          relative_tolerance=1e-6))
    A, bt = port_of(J), torch.from_numpy(b)
    x, mon = solvers.refine(A, bt, config={"impl": "binned"}, inner_rtol=1e-3,
                            monitor=solvers.Monitor(bt, iteration_limit=12,
                                                    relative_tolerance=1e-6))
    assert mon.converged() and mj.converged(), mon.residuals
    r = b - J.to_scipy() @ x.numpy().astype(np.float64)
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b) * 1.01
    assert mon.iteration_count() <= 6
    xj = np.asarray(xj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=0, atol=3e-4 * np.abs(xj).max())


def test_refine_matches_plain_cg_solution():
    """tests/test_mixed.py:92: mixed_precision_cg's x against plain CG's,
    on both packages."""
    J = jgallery.poisson5pt(16, 16, format="dia", dtype=np.float32)
    b = np.random.default_rng(5).standard_normal(J.num_rows).astype(np.float32)
    A, bt = port_of(J), torch.from_numpy(b)
    x_ref, m1 = solvers.cg(A, bt, monitor=solvers.Monitor(
        bt, iteration_limit=400, relative_tolerance=1e-6))
    x_mp, m2 = solvers.mixed_precision_cg(A, bt, monitor=solvers.Monitor(
        bt, iteration_limit=10, relative_tolerance=1e-6))
    xj, mj = js.mixed_precision_cg(J, jnp.asarray(b), monitor=js.Monitor(
        jnp.asarray(b), iteration_limit=10, relative_tolerance=1e-6))
    assert m1.converged() and m2.converged() and mj.converged()
    denom = float(x_ref.abs().max())
    assert float((x_mp - x_ref).abs().max()) / denom < 1e-4
    assert np.abs(x_mp.numpy() - np.asarray(xj)).max() / denom < 1e-4


def test_refine_plans_bf16_and_matches_jax_interpret():
    """The inner plan stores bf16 values, and its product (the binned
    kernel's plain version here) equals the JAX package's bf16 binned plan
    run in interpret mode to the f32 accumulation's rounding."""
    J = jgallery.poisson5pt(24, 24, format="csr", dtype=np.float32)
    rng = np.random.RandomState(2)
    S = J.to_scipy().tocoo()
    S.data = (S.data * rng.uniform(0.5, 1.5, S.nnz)).astype(np.float32)
    J = jfrom_scipy(S, "csr")
    cfg = {"impl": "binned", "value_dtype": "bfloat16"}
    op = planned_operator(port_of(J), cfg)
    assert op.arrays["val"].dtype == torch.bfloat16
    x = rng.standard_normal(J.num_cols).astype(np.float32)
    y = op(torch.from_numpy(x)).numpy()
    yj = np.asarray(jplanned_operator(J, cfg)(jnp.asarray(x)))
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())
    exact = S.toarray().astype(np.float64) @ x
    e = np.abs(y - exact).max() / np.abs(exact).max()
    assert 1e-5 < e < 3e-2          # bf16 rounding applied, and bounded


def test_refine_takes_an_operator_and_another_inner_solver():
    """An operator A serves both the outer residual and the inner solves,
    and the inner solver may be a non-symmetric one."""
    S = (sp.random(200, 200, density=0.03, random_state=np.random.RandomState(2))
         + sp.diags(np.full(200, 6.0))).astype(np.float32)
    A = from_scipy(S, "csr", device=CPU)
    b = torch.ones(200)
    x, mon = solvers.refine(A, b, inner=solvers.gmres, config={"impl": "binned"},
                            monitor=solvers.Monitor(b, 10, 1e-6))
    assert mon.converged()
    op = planned_operator(A)
    x2, mon2 = solvers.refine(op, b, inner=solvers.bicgstab,
                              monitor=solvers.Monitor(b, 10, 1e-6))
    assert mon2.converged() and mon2.iteration_count() <= 2
    for xx in (x, x2):
        r = b.numpy() - S @ xx.numpy()
        assert np.linalg.norm(r) <= 1.01e-6 * np.linalg.norm(b.numpy())
