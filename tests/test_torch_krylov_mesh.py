"""The Krylov solvers with mesh=, on the CPU: at the input of the JAX
package's multichip dry run (__graft_entry__.py:177-236, poisson5pt(16,
64) CSR with b = ones, the default monitor, restart 20 for gmres, the
shifts [0, 0.5, 2] under Monitor(b, 80, 1e-6) for cg_m and bicgstab_m),
each of the six solvers on a RowMesh of four CPU entries takes the
iteration count of its unsharded solve and of the JAX package's unsharded
solve.

One f32 count differs from the JAX package's: bicgstab takes 41
iterations in the port and 43 in the JAX package (MULTICHIP_r05.json's
count).  The two histories first differ in the seventh digit at iteration
1, where XLA and torch sum the dot products in different orders, and
BiCGstab's f32 history on this input is erratic (it jumps twentyfold at
iteration 28 in the JAX package), so the rounding decides the last
iterations.  In f64 all six counts are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusp_autotuned_tpu import gallery as jgallery, solvers as js

from cusp_autotuned_tpu_torch import parallel, solvers
from cusp_autotuned_tpu_torch.solvers import Monitor

from tests.torch_parity import one_thread, port_of  # noqa: F401

SIGMA = [0.0, 0.5, 2.0]
# name -> (JAX solver, port solver, keyword arguments, shifted)
SOLVES = {"bicg": (js.bicg, solvers.bicg, {}, False),
          "gmres": (js.gmres, solvers.gmres, {"restart": 20}, False),
          "cr": (js.cr, solvers.cr, {}, False),
          "bicgstab": (js.bicgstab, solvers.bicgstab, {}, False),
          "cg_m": (js.cg_m, solvers.cg_m, {}, True),
          "bicgstab_m": (js.bicgstab_m, solvers.bicgstab_m, {}, True)}
MULTICHIP_F32 = {"bicg": 56, "gmres": 102, "cr": 56, "bicgstab": 43,
                 "cg_m": 62, "bicgstab_m": 46}      # MULTICHIP_r05.json


def _run(fn, A, b, kw, shifted, monitor, **mesh):
    if shifted:
        return fn(A, b, np.asarray(SIGMA, b.dtype if isinstance(b, np.ndarray)
                                   else np.float64),
                  monitor=monitor(b, 80, 1e-6), **mesh)
    return fn(A, b, **kw, **mesh)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_mesh_counts_equal_unsharded_and_jax(name, dtype):
    jfn, pfn, kw, shifted = SOLVES[name]
    J = jgallery.poisson5pt(16, 64, format="csr", dtype=dtype)
    b = np.ones(J.num_rows, dtype)
    _, mj = _run(jfn, J, jnp.asarray(b), kw, shifted, js.Monitor)
    A, bt = port_of(J), torch.from_numpy(b)
    x1, m1 = _run(pfn, A, bt, kw, shifted, Monitor)
    mesh = parallel.make_row_mesh([torch.device("cpu")] * 4)
    xm, mm = _run(pfn, A, bt, kw, shifted, Monitor, mesh=mesh)
    assert mm.converged() and m1.converged() and mj.converged()
    assert mm.iteration_count() == m1.iteration_count()
    np.testing.assert_allclose(xm.numpy(), x1.numpy(), rtol=1e-5,
                               atol=1e-5 * float(x1.abs().max()))
    if dtype == np.float32:
        assert mj.iteration_count() == MULTICHIP_F32[name]
    if dtype == np.float32 and name == "bicgstab":
        # the module docstring says why
        assert abs(m1.iteration_count() - mj.iteration_count()) <= 2
    else:
        assert m1.iteration_count() == mj.iteration_count()
