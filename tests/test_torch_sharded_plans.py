"""The port's planned operators over a mesh (parallel/sharded_plans.py) and
the DIA band kernels' plain versions, on the CPU.

shard_planned_dia is held to the JAX package's on a 4-device mesh of the
conftest's host devices (Pallas in interpret mode), for a vector and for a
block of 16 columns, at rtol 1e-5 in f32.  Each band's plain version
equals the rows of the unsharded plain product to rtol 1e-6 in f32 (the
same diagonals added in the same order; bf16 storage and f64 alike).
shard_planned_blocks on its three rails is held to the scipy oracle, and a
distributed AMG hierarchy's V-cycle to the unsharded one at 1e-5.  At the
JAX package's multichip dry-run shapes on eight CPU entries the
sharded-plan AMG-CG takes 16 iterations and CG through the sharded routed
plan 28, the counts of MULTICHIP_r05.json."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery
from cusp_autotuned_tpu.kernels import streaming as jstreaming
from cusp_autotuned_tpu.parallel import make_row_mesh as jax_make_row_mesh
from cusp_autotuned_tpu.parallel.sharded_plans import (
    shard_planned_dia as jax_shard_planned_dia,
)

from cusp_autotuned_tpu_torch import autotune, gallery, parallel, precond, solvers
from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.kernels import streaming
from cusp_autotuned_tpu_torch.kernels.dia import (
    _pad_rows, dia_band_spmv_plain, dia_spmv_plain,
)
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.parallel import ShardedPlannedOperator
from cusp_autotuned_tpu_torch.parallel.sharded import ShardedMatrix
from cusp_autotuned_tpu_torch.parallel.sharded_plans import dia_bands
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import InvalidInputException

from tests.torch_parity import one_thread, port_of, skewed_random  # noqa: F401

CPU = torch.device("cpu")


def _mesh(n=4):
    return parallel.make_row_mesh([CPU] * n)


@pytest.mark.parametrize("k", [0, 16])
def test_shard_planned_dia_matches_jax(k):
    J = jgallery.poisson5pt(24, 40, format="dia", dtype=np.float32)
    rng = np.random.RandomState(k)
    x = rng.randn(*((J.num_cols,) if k == 0 else (J.num_cols, k))).astype(np.float32)
    want = np.asarray(jax_shard_planned_dia(J, jax_make_row_mesh(jax.devices()[:4]))(
        jnp.asarray(x)))
    op = parallel.shard_planned_dia(port_of(J), _mesh())
    assert op.impl == "via_dia_sharded" and op.out_mode == "banded"
    band = op.arrays[0]["data"].shape[1]
    assert all(a["data"].shape == (5, band) for a in op.arrays)
    y = op(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(InvalidInputException):
        parallel.shard_planned_dia(port_of(J), _mesh(), {"block_rows": 1024})


@pytest.mark.parametrize("dtype,store,k", [
    (torch.float32, None, 1), (torch.float32, None, 3), (torch.float32, None, 16),
    (torch.float32, torch.bfloat16, 1), (torch.float64, None, 1)])
def test_band_plain_equals_the_unsharded_rows(dtype, store, k):
    S = sp.diags([np.random.RandomState(d).uniform(0.5, 2.0, 300) for d in range(5)],
                 [-37, -1, 0, 2, 60], shape=(300, 300))
    D = from_scipy(S, "dia", dtype=dtype, device="cpu")
    if store is not None:
        D = D.__class__(data=D.data.to(store), offsets=D.offsets, shape=D.shape,
                        nnz=D.nnz)
    x = torch.from_numpy(np.random.RandomState(7).randn(300, k)).to(dtype)
    x = x[:, 0] if k == 1 else x
    whole = dia_spmv_plain(D.data, D.offsets, x, D.shape)
    data, band, left, x_rows = dia_bands(D, 3)
    x_pad = _pad_rows(x, left, x_rows - left - 300)
    for i in range(3):
        y = dia_band_spmv_plain(data[:, i * band:(i + 1) * band], D.offsets,
                                x_pad, left, i * band)
        rows = whole[i * band:(i + 1) * band]
        torch.testing.assert_close(y[:rows.shape[0]], rows, rtol=1e-6, atol=0)


def _skewed(n, seed):
    return from_scipy(skewed_random(n, seed, max_len=300), "csr",
                      dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("impl,cfg,out_mode", [
    ("binned", {}, "banded"),
    ("routed", {"window": 4096}, "banded"),
    ("colsort2", {"vrow_planes": 2, "vrow_len": 8}, "sum"),
    ("colsort2", {"hub_cap": 4096}, "banded"),
])
def test_shard_planned_blocks_matches_the_oracle(impl, cfg, out_mode):
    A = _skewed(1500, 11)
    op = parallel.shard_planned_blocks(A, _mesh(), {"impl": impl, **cfg})
    assert op.impl == f"{impl}_sharded" and op.out_mode == out_mode
    nnz = [a["val"].numel() for a in op.arrays]
    if out_mode == "banded":
        assert max(nnz) < 0.5 * A.nnz       # the parts share the entries
    x = np.random.RandomState(12).randn(1500).astype(np.float32)
    want = A.to_scipy() @ x.astype(np.float64)
    np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    X = np.random.RandomState(13).randn(1500, 4).astype(np.float32)
    np.testing.assert_allclose(op(torch.from_numpy(X)).numpy(),
                               A.to_scipy() @ X.astype(np.float64), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("spmv_config", [{}, None])
def test_distribute_multilevel_vcycle_matches_unsharded(spmv_config):
    A = gallery.poisson5pt(128, 128, format="csr", device="cpu")
    M = precond.smoothed_aggregation(A, spmv_config=spmv_config)
    Md = parallel.distribute_multilevel(M, _mesh(), cutoff=2048)
    lv0 = Md.levels[0]
    if spmv_config is None:
        assert isinstance(lv0.A, ShardedMatrix)
    else:
        assert isinstance(lv0.Aop, ShardedPlannedOperator)
        assert lv0.Aop.impl == "via_dia_sharded"
        assert lv0.Pop.Aop is lv0.Aop and lv0.Rop.Aop is lv0.Aop
        assert isinstance(lv0.Pop.Top, ShardedMatrix)
        assert isinstance(lv0.Rop.Ttop, ShardedMatrix)
    b = torch.from_numpy(np.random.RandomState(9).rand(A.num_rows).astype(np.float32))
    want = M(b)
    torch.testing.assert_close(Md(b), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_sharded_plan_counts_at_the_dryrun_shapes():
    """__graft_entry__.py's dryrun_multichip(8) shapes on eight CPU
    entries: sharded-plan AMG-CG 16 iterations, CG through the sharded
    routed plan on Economics 28, as MULTICHIP_r05.json records."""
    mesh = _mesh(8)
    A = port_of(jgallery.poisson5pt(64, 64, format="csr", dtype=np.float32))
    b = torch.ones(A.num_rows)
    M = precond.smoothed_aggregation(A, spmv_config={}, min_level_size=400)
    _, mon_s = solvers.cg(A, b, M=M, monitor=Monitor(b, 60, 1e-8))
    Md = parallel.distribute_multilevel(M, mesh, cutoff=2048)
    assert isinstance(Md.levels[0].Aop, ShardedPlannedOperator)
    _, mon_d = solvers.cg(A, b, M=Md, monitor=Monitor(b, 60, 1e-8), mesh=mesh)
    assert mon_d.converged()
    assert mon_d.iteration_count() == mon_s.iteration_count() == 16

    S = gallery.williams_suite(0.12)["Economics"].astype(np.float32).tocsr()
    S = (0.5 * (S + S.T)).tocsr()
    S = (S + sp.diags(np.abs(S).sum(axis=1).A1 + 1.0)).tocsr()
    Ae = from_scipy(S, "csr", device="cpu")
    op = parallel.shard_planned_blocks(Ae, mesh, {"impl": "routed"})
    assert op.impl == "routed_sharded" and len(op.arrays) == 8
    be = torch.ones(Ae.num_rows)
    _, m_s = solvers.cg(Ae, be, monitor=Monitor(be, 40, 1e-6))
    _, m_d = solvers.cg(op, be, monitor=Monitor(be, 40, 1e-6))
    assert m_d.converged()
    assert m_d.iteration_count() == m_s.iteration_count() == 28


def test_tuned_operator_mesh_bands_the_dia_kernel():
    A = gallery.poisson5pt(32, 32, format="dia", device="cpu")
    autotune.reset_tuning(A)
    op = autotune.tuned_operator(A, mesh=_mesh())
    assert op.impl == "via_dia_sharded"
    x = torch.from_numpy(np.random.RandomState(4).randn(A.num_cols).astype(np.float32))
    torch.testing.assert_close(op(x), dia_spmv_plain(A.data, A.offsets, x, A.shape),
                               rtol=1e-6, atol=1e-6)
    C = convert(A, "csr")
    rep = autotune.tuned_operator(C, mesh=_mesh())
    assert rep.impl.endswith(("_sharded", "_replicated"))


def test_band_mask_matches_jax_and_selects():
    visited = np.array([0, 2, 2])
    want = np.asarray(jstreaming.band_mask(visited, 4, 3, np.float32))
    mask = streaming.band_mask(visited, 4, 3, torch.float32)
    np.testing.assert_array_equal(mask.numpy(), want)
    yv = torch.full((12, 2), float("nan"))
    out = streaming.apply_band_mask(yv, mask)
    assert torch.isnan(out[:3]).all() and (out[3:6] == 0).all()
