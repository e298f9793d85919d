"""The port's multi-device path (parallel/sharded.py and
parallel/shard_map_spmv.py) against the JAX package's, on the CPU.

The JAX functions run on a 4-device mesh of the conftest's host devices,
their Pallas kernels in interpret mode; the port's on a RowMesh of four CPU
entries, through the kernels' plain versions.  The same seeded numpy
inputs go to both.  SpMVs agree to rtol 1e-5 in f32, and the fixed-
iteration solvers after 5 iterations to rtol 1e-4, atol 1e-5 (the
tolerances of the JAX package's multichip dry run, __graft_entry__.py:99,
114, 132).  Last, at the dry run's own shapes on eight CPU entries, the
port's solves take the iteration counts that MULTICHIP_r05.json records
for the JAX package: cg(mesh=) 56, AMG-CG(mesh=) 16, and lanczos(mesh=)
gives the single-device largest eigenvalue."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery, parallel as jpar
from cusp_autotuned_tpu.backend.reference import from_scipy as jfrom_scipy

from cusp_autotuned_tpu_torch import eigen, parallel, precond, solvers
from cusp_autotuned_tpu_torch.backend.reference import from_scipy
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
from cusp_autotuned_tpu_torch.utils.exceptions import (
    InvalidInputException, NotImplementedException,
)

from tests.torch_parity import one_thread, port_of  # noqa: F401

CPU = torch.device("cpu")
SPMV_RTOL = 1e-5
SOLVE_RTOL, SOLVE_ATOL = 1e-4, 1e-5
ITERATIONS = 5


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh), four entries each."""
    return jpar.make_row_mesh(jax.devices()[:4]), parallel.make_row_mesh([CPU] * 4)


def _close(got, want, rtol, atol_scale=None):
    want = np.asarray(want)
    atol = rtol * np.abs(want).max() if atol_scale is None else atol_scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def test_make_row_mesh_uses_cuda_or_raises():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in parallel.make_row_mesh().devices)
    else:
        with pytest.raises(InvalidInputException):
            parallel.make_row_mesh()
    mesh = parallel.make_row_mesh([CPU] * 4)
    assert mesh.size == 4 and mesh.home == CPU
    x = torch.ones(3)
    assert all(c is x for c in parallel.replicate(x, mesh))


@pytest.mark.parametrize("fmt", ["dia", "csr", "coo", "ell", "ellr", "hyb"])
def test_shard_rows_matches_the_oracle(fmt):
    A = convert(port_of(jgallery.poisson9pt(10, 13, format="csr",
                                            dtype=np.float32)), fmt)
    S = parallel.shard_rows(A, parallel.make_row_mesh([CPU] * 4))
    assert len(S.blocks) == 4 and S.row_starts[-1] == A.num_rows
    assert all(b.format == fmt for b in S.blocks)
    x = np.random.RandomState(0).randn(A.num_cols).astype(np.float32)
    _close(parallel.sharded_spmv(S, torch.from_numpy(x)),
           A.to_scipy() @ x.astype(np.float64), SPMV_RTOL)


def test_sharded_spmv_dia_matches_jax(meshes):
    jmesh, mesh = meshes
    J = jgallery.poisson5pt(16, 32, format="dia", dtype=np.float32)
    x = np.random.RandomState(1).randn(J.num_cols).astype(np.float32)
    want = jpar.sharded_spmv_dia_shardmap(J, jmesh)(jnp.asarray(x))
    got = parallel.sharded_spmv_dia_shardmap(port_of(J), mesh)(torch.from_numpy(x))
    _close(got, want, SPMV_RTOL)


def _hub_matrix():
    """tests/test_parallel.py's hub-spill case at half its size: a seeded
    random 512 x 512 matrix plus the identity, and one dense row that
    crosses the entries' row bands."""
    rng = np.random.RandomState(5)
    S = (sp.random(512, 512, density=0.01, random_state=rng) + sp.eye(512)).tolil()
    S[3, :200] = 1.0
    return S.tocsr().astype(np.float32)


@pytest.mark.parametrize("rail,jax_cfg", [
    ("binned", {"block_entries": 512, "col_window": 2048, "row_window": 128,
                "hub_cap": 16}),
    ("colsort", {"block_entries": 512, "col_window": 2048, "row_window": 256,
                 "hub_cap": 16}),
])
def test_row12_shardmap_spmv_matches_jax(meshes, rail, jax_cfg):
    jmesh, mesh = meshes
    S = _hub_matrix()
    J = jfrom_scipy(S.tocoo(), "csr", dtype=np.float32)
    x = np.random.RandomState(2).randn(512).astype(np.float32)
    jfn = {"binned": jpar.sharded_spmv_binned_shardmap,
           "colsort": jpar.sharded_spmv_colsort_shardmap}[rail]
    fn = {"binned": parallel.sharded_spmv_binned_shardmap,
          "colsort": parallel.sharded_spmv_colsort_shardmap}[rail]
    want = jax.jit(jfn(J, jmesh, jax_cfg))(jnp.asarray(x))
    op = fn(port_of(J), mesh, {"hub_cap": 16} if rail == "binned" else {})
    assert op.impl == f"{rail}_sharded" and len(op.arrays) == 4
    _close(op(torch.from_numpy(x)), want, SPMV_RTOL)
    with pytest.raises(InvalidInputException):
        fn(port_of(J), mesh, jax_cfg)


def _jax_solve(name, JD, JC, b, jmesh):
    cfg = {"block_entries": 512, "col_window": 2048, "row_window": 256}
    return {
        "cg": lambda: jpar.distributed_cg(JD, b, jmesh, ITERATIONS),
        "cg_shardmap": lambda: jpar.distributed_cg_shardmap(JD, b, jmesh, ITERATIONS),
        "cg_halo": lambda: jpar.distributed_cg_halo(JD, b, jmesh, ITERATIONS),
        "cg_binned": lambda: jpar.distributed_cg_binned(
            JC, b, jmesh, cfg, ITERATIONS),
        "cg_colsort": lambda: jpar.distributed_cg_binned(
            JC, b, jmesh, cfg, ITERATIONS, impl="colsort"),
        "bicgstab": lambda: jpar.distributed_bicgstab(JC, b, jmesh, ITERATIONS),
    }[name]()


def _port_solve(name, D, C, b, mesh):
    return {
        "cg": lambda: parallel.distributed_cg(D, b, mesh, ITERATIONS),
        "cg_shardmap": lambda: parallel.distributed_cg_shardmap(D, b, mesh, ITERATIONS),
        "cg_halo": lambda: parallel.distributed_cg_halo(D, b, mesh, ITERATIONS),
        "cg_binned": lambda: parallel.distributed_cg_binned(
            C, b, mesh, iterations=ITERATIONS),
        "cg_colsort": lambda: parallel.distributed_cg_binned(
            C, b, mesh, iterations=ITERATIONS, impl="colsort"),
        "bicgstab": lambda: parallel.distributed_bicgstab(C, b, mesh, ITERATIONS),
    }[name]()


@pytest.mark.parametrize("name", ["cg", "cg_shardmap", "cg_halo", "cg_binned",
                                  "cg_colsort", "bicgstab"])
def test_distributed_solvers_match_jax(meshes, name):
    jmesh, mesh = meshes
    JD = jgallery.poisson5pt(16, 32, format="dia", dtype=np.float32)
    JC = jgallery.poisson5pt(16, 32, format="csr", dtype=np.float32)
    b = np.random.RandomState(3).rand(JD.num_rows).astype(np.float32)
    xj, rj = _jax_solve(name, JD, JC, b, jmesh)
    x, r = _port_solve(name, port_of(JD), port_of(JC), torch.from_numpy(b), mesh)
    _close(x, xj, SOLVE_RTOL, SOLVE_ATOL)
    _close(r, rj, SOLVE_RTOL, SOLVE_ATOL)


def test_halo_and_shardmap_refusals():
    mesh = parallel.make_row_mesh([CPU] * 4)
    C = port_of(jgallery.poisson5pt(8, 8, format="csr", dtype=np.float32))
    b = torch.ones(64)
    for fn in (parallel.distributed_cg_shardmap, parallel.distributed_cg_halo):
        with pytest.raises(NotImplementedException):
            fn(C, b, mesh)
    # 64 rows in bands of 16: a diagonal 20 rows off reaches past a band
    wide = from_scipy(sp.diags([np.ones(44), 4 * np.ones(64), np.ones(44)],
                               [-20, 0, 20]), "dia", dtype=torch.float32,
                      device="cpu")
    with pytest.raises(NotImplementedException):
        parallel.distributed_cg_halo(wide, b, mesh)
    rect = from_scipy(sp.random(6, 8, density=0.5, random_state=0), "csr",
                      dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedException):
        parallel.distributed_cg_binned(rect, torch.ones(6), mesh)


def test_multichip_counts_at_the_dryrun_shapes():
    """__graft_entry__.py's dryrun_multichip(8) shapes on eight CPU
    entries: the iteration counts of MULTICHIP_r05.json."""
    mesh = parallel.make_row_mesh([CPU] * 8)
    Ac = port_of(jgallery.poisson5pt(16, 64, format="csr", dtype=np.float32))
    b = torch.ones(Ac.num_rows)
    x5, mon = solvers.cg(Ac, b, mesh=mesh)
    assert mon.converged() and mon.iteration_count() == 56
    _close(x5, solvers.cg(Ac, b)[0], SOLVE_RTOL, SOLVE_ATOL)

    Am = port_of(jgallery.poisson5pt(32, 32, format="csr", dtype=np.float32))
    bm = torch.ones(Am.num_rows)
    M = precond.smoothed_aggregation(Am, min_level_size=60)
    _, mon_s = solvers.cg(Am, bm, M=M, monitor=Monitor(bm, 60, 1e-8))
    _, mon_d = solvers.cg(Am, bm, M=M, monitor=Monitor(bm, 60, 1e-8), mesh=mesh)
    assert mon_d.converged()
    assert mon_d.iteration_count() == mon_s.iteration_count() == 16

    ev = eigen.lanczos(Ac, mesh=mesh)
    assert float(ev[0]) == float(eigen.lanczos(Ac)[0])
    assert abs(float(ev[0]) - 7.9636) < 5e-5
