"""Row-sharded solves over a device mesh: the JAX package's extension
beyond the single-GPU reference.  Here the mesh is a RowMesh of four
entries, on the card unless `device` names another: four entries on one
device run every sharded code path (bands, gathers, per-entry plans) in
one process; entries on distinct cards spread them."""

import sys

import numpy as np
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu_torch import gallery, solvers
from cusp_autotuned_tpu_torch.parallel import (
    make_row_mesh, distributed_cg, distributed_cg_shardmap,
)
from cusp_autotuned_tpu_torch.utils.config import resolve_device

MESH_ENTRIES = 4


def main(device=None, nx=64, n2=64, n_scattered=2000):
    mesh = make_row_mesh([resolve_device(device)] * MESH_ENTRIES)
    n_dev = mesh.size
    A = gallery.poisson5pt(nx, 16 * n_dev, format="dia", dtype=torch.float32,
                           device=mesh.home)
    b = torch.ones(A.num_rows, dtype=torch.float32, device=mesh.home)

    x1, r1 = distributed_cg(A, b, mesh, iterations=50)           # row bands
    x2, r2 = distributed_cg_shardmap(A, b, mesh, iterations=50)  # band kernels
    print(f"{n_dev}-device CG: ||r|| = {float(r1):.3e} (gspmd), "
          f"{float(r2):.3e} (shard_map)")

    # the public solver API distributes with a mesh argument: the monitored
    # loop's vectors and dot products stay on the home device
    x3, mon = solvers.cg(A, b, mesh=mesh)
    print(f"public cg(mesh=): converged={mon.converged()} in "
          f"{mon.iteration_count()} iterations")

    Ac = gallery.poisson5pt(nx, 16 * n_dev, format="csr", dtype=torch.float32,
                            device=mesh.home)
    x4, mon4 = solvers.bicgstab(Ac, b, mesh=mesh)
    print(f"public bicgstab(mesh=) on row-aligned CSR: "
          f"converged={mon4.converged()}")

    # bicg distributes too: the set-up A^T is row-sharded alongside A
    x5, mon5 = solvers.bicg(Ac, b, mesh=mesh)
    print(f"public bicg(mesh=): converged={mon5.converged()}")

    # distributed AMG: fine levels row-sharded, coarse levels and the LU
    # on the home device; one V-cycle per CG iteration
    from cusp_autotuned_tpu_torch.precond.aggregation import smoothed_aggregation
    from cusp_autotuned_tpu_torch.solvers.monitor import Monitor
    M = smoothed_aggregation(Ac, min_level_size=100)
    x6, mon6 = solvers.cg(Ac, b, M=M, monitor=Monitor(b, 100, 1e-8), mesh=mesh)
    print(f"AMG-preconditioned cg(mesh=): converged={mon6.converged()} in "
          f"{mon6.iteration_count()} iterations")

    # tuned operators shard too: a planned hierarchy's via_dia plans band
    # over the mesh (each entry holds only its row band's diagonals) and
    # the factored R and P shard their grid-blocked tentative operators
    from cusp_autotuned_tpu_torch.parallel.sharded import distribute_multilevel
    A2 = gallery.poisson5pt(n2, n2, format="csr", dtype=torch.float32,
                            device=mesh.home)
    b2 = torch.ones(A2.num_rows, dtype=torch.float32, device=mesh.home)
    Mp = smoothed_aggregation(A2, spmv_config={}, min_level_size=400)
    Mpd = distribute_multilevel(Mp, mesh, cutoff=2048)
    x7, mon7 = solvers.cg(A2, b2, M=Mpd, monitor=Monitor(b2, 100, 1e-8), mesh=mesh)
    lv0 = Mpd.levels[0]
    print(f"sharded-plan AMG-CG: converged={mon7.converged()} in "
          f"{mon7.iteration_count()} iterations "
          f"(fine Aop = {getattr(lv0.Aop, 'impl', '?')})")

    # scattered planned rails shard too: one colsort2 plan partitioned by
    # rows over the mesh (about equal entries a part, hub rows split by
    # entry and the parts' outputs added), so a tuned scattered operator
    # is spread instead of replicated
    from cusp_autotuned_tpu_torch.backend.reference import (from_scipy,
                                                            reference_spmv)
    from cusp_autotuned_tpu_torch.parallel.sharded_plans import shard_planned_blocks
    rng = np.random.RandomState(0)
    n = n_scattered
    Ssc = (sp.random(n, n, density=2e-3, random_state=rng, dtype=np.float32)
           + sp.eye(n, dtype=np.float32)).tocsr()
    Asc = from_scipy(Ssc, "csr", device=mesh.home)
    op = shard_planned_blocks(Asc, mesh, {"impl": "colsort2"})
    xs = rng.randn(n).astype(np.float32)
    err = float(np.abs(op(torch.as_tensor(xs, device=mesh.home)).cpu().numpy()
                       - reference_spmv(Asc, xs)).max())
    print(f"sharded scattered plan ({op.impl}): max |err| = {err:.2e}")
    return {"entries": n_dev, "r_gspmd": float(r1), "r_shardmap": float(r2),
            "cg_iterations": mon.iteration_count(), "cg_converged": mon.converged(),
            "bicgstab_converged": mon4.converged(), "bicg_converged": mon5.converged(),
            "amg_iterations": mon6.iteration_count(), "amg_converged": mon6.converged(),
            "sharded_amg_iterations": mon7.iteration_count(),
            "sharded_amg_converged": mon7.converged(),
            "fine_impl": getattr(lv0.Aop, "impl", "?"), "scattered_err": err}


if __name__ == "__main__":
    main(*sys.argv[1:])
