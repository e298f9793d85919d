"""The port's examples (cusp_autotuned_tpu_torch/examples) against the JAX
package's examples/01-09, on the CPU.

Examples 01, 02, 05 and 09 run in both packages as they are, and the
port's numbers are held against the ones the JAX example prints.  The JAX
examples 03, 04, 06, 07 and 08 take 7-15 s each on the CPU, so for those
the test makes the JAX example's calls itself at a smaller size and holds
the port's example, run at that size, against them.

Bars: iteration counts equal in f64, within 2 in f32 (the two packages'
f32 sums part at the 1e-5 level within tens of iterations); residuals of
f64 solves within 1e-4, relative; an f32 solve's residual below its
monitor's tolerance.  Example 09's f32 matrix-free CG takes 122 iterations
in the JAX package and 101 in the port, where both take 101 in f64 with
equal residuals: the test holds the port's f32 example to the f64 count,
within 2, and the two packages' f64 solves to each other."""

import importlib.util
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from cusp_autotuned_tpu import autotune as jautotune
from cusp_autotuned_tpu import gallery as jgallery, precond as jprecond
from cusp_autotuned_tpu import solvers as jsolvers
from cusp_autotuned_tpu.autotune import tuner as jtuner_mod

from cusp_autotuned_tpu_torch import examples
from cusp_autotuned_tpu_torch.autotune import tuner as tuner_mod

from tests.torch_parity import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ITERATIONS = 2
RESIDUAL_RTOL = 1e-4


def jax_example(name, capsys):
    """Run the JAX package's example `name` and return what it printed."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def port_example(name, capsys, **sizes):
    """(the dict the port's example returns, what it printed) on the CPU."""
    capsys.readouterr()
    got = examples.load(name).main("cpu", **sizes)
    return got, capsys.readouterr().out


@pytest.fixture
def fresh_tuners(monkeypatch):
    """Both packages' global tuners fresh for the test, and restored after."""
    monkeypatch.setattr(jtuner_mod, "_global_tuner", None)
    monkeypatch.setattr(tuner_mod, "_global_tuner", None)


def check_01(capsys):
    want = jax_example("01_formats_and_convert", capsys)
    got, printed = port_example("01_formats_and_convert", capsys)
    assert got["entries"] == {f: int(n) for f, n in
                              re.findall(r"^(\w+): (\d+) entries", want, re.M)}
    # print_matrix and spy write the same text in both packages
    assert printed.split("csr:")[0] == want.split("csr:")[0]
    assert printed.split("+", 1)[1] == want.split("+", 1)[1]


def check_02(capsys):
    want = jax_example("02_solve_poisson", capsys)
    its, res, tol = re.search(r"monitor: (\d+) iterations, residual (\S+) "
                              r"\(tolerance (\S+)\), converged", want).groups()
    got, _ = port_example("02_solve_poisson", capsys)
    assert got["converged"]
    assert abs(got["iterations"] - int(its)) <= F32_ITERATIONS
    assert got["residual"] <= float(tol) and float(res) <= float(tol)


def check_03(capsys):
    n = 40
    A = jgallery.poisson5pt(n, n, format="csr", dtype=np.float64)
    b = np.random.RandomState(0).randn(A.num_rows)
    M = jprecond.smoothed_aggregation(A)
    _, mon_amg = jsolvers.cg(A, b, M=M, monitor=jsolvers.Monitor(b, 100, 1e-8))
    _, mon_cg = jsolvers.cg(A, b, monitor=jsolvers.Monitor(b, 2000, 1e-8))
    from cusp_autotuned_tpu.operators import planned_operator
    cfg = {"impl": "binned", "block_entries": 4096, "col_window": 2048,
           "row_window": 768}
    Af = jgallery.poisson5pt(n, n, format="csr", dtype=np.float32)
    bt = b.astype(np.float32)
    _, mont = jsolvers.cg(planned_operator(Af, cfg), bt,
                          M=jprecond.smoothed_aggregation(Af, spmv_config=cfg),
                          monitor=jsolvers.Monitor(bt, 100, 1e-5))
    got, _ = port_example("03_amg_preconditioner", capsys, n=n)
    assert got["levels"] == len(M.levels) + 1
    np.testing.assert_allclose(got["operator_complexity"],
                               M.operator_complexity(), rtol=1e-12)
    assert got["amg_iterations"] == mon_amg.iteration_count()
    assert got["cg_iterations"] == mon_cg.iteration_count()
    np.testing.assert_allclose(got["amg_residual"], mon_amg.residual_norm(),
                               rtol=RESIDUAL_RTOL)
    assert got["tuned_converged"] and mont.converged()
    assert abs(got["tuned_iterations"] - mont.iteration_count()) <= F32_ITERATIONS


def check_04(capsys):
    from cusp_autotuned_tpu.backend.reference import reference_spmv
    n = 10_000
    A = jgallery.make_diagonal_symmetric_matrix(n, n, 3, 9)
    x = np.random.RandomState(0).randn(A.num_cols).astype(np.float32)
    results = jautotune.tune(A, x, reference_computation=reference_spmv)
    best = jautotune.get_tuner().best_configuration(A)
    y = np.asarray(jautotune.multiply(A, jnp.asarray(x), configuration=best))
    got, printed = port_example("04_autotuned_spmv", capsys, n=n)
    assert {r.status.value for r in results} == set(got["statuses"]) == {"Ok"}
    assert "best configuration:" in printed
    ref = reference_spmv(A, x)
    assert got["y_rel_err"] <= 1e-6
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) <= 1e-6


def check_05(capsys):
    want = jax_example("05_graph_and_io", capsys)
    got, printed = port_example("05_graph_and_io", capsys)
    assert printed == want
    assert got["components"] == 1 and got["roundtrip_nnz"] == 224


def check_06(capsys):
    from cusp_autotuned_tpu.parallel import (
        distributed_cg, distributed_cg_shardmap, make_row_mesh)
    from cusp_autotuned_tpu.parallel.sharded import distribute_multilevel
    nx, n2, n_sc = 16, 48, 500
    mesh = make_row_mesh(jax.devices()[:examples.load("06_multichip").MESH_ENTRIES])
    n_dev = mesh.devices.size
    A = jgallery.poisson5pt(nx, 16 * n_dev, format="dia", dtype=np.float32)
    b = np.ones(A.num_rows, np.float32)
    _, r1 = distributed_cg(A, b, mesh, iterations=50)
    _, r2 = distributed_cg_shardmap(A, b, mesh, iterations=50)
    _, mon = jsolvers.cg(A, b, mesh=mesh)
    Ac = jgallery.poisson5pt(nx, 16 * n_dev, format="csr", dtype=np.float32)
    _, mon4 = jsolvers.bicgstab(Ac, b, mesh=mesh)
    _, mon5 = jsolvers.bicg(Ac, b, mesh=mesh)
    M = jprecond.smoothed_aggregation(Ac, min_level_size=100)
    _, mon6 = jsolvers.cg(Ac, b, M=M, monitor=jsolvers.Monitor(b, 100, 1e-8),
                          mesh=mesh)
    A2 = jgallery.poisson5pt(n2, n2, format="csr", dtype=np.float32)
    b2 = np.ones(A2.num_rows, np.float32)
    Mpd = distribute_multilevel(
        jprecond.smoothed_aggregation(A2, spmv_config={}, min_level_size=400),
        mesh, cutoff=2048)
    _, mon7 = jsolvers.cg(A2, b2, M=Mpd, monitor=jsolvers.Monitor(b2, 100, 1e-8),
                          mesh=mesh)

    got, _ = port_example("06_multichip", capsys, nx=nx, n2=n2, n_scattered=n_sc)
    assert got["entries"] == n_dev
    np.testing.assert_allclose([got["r_gspmd"], got["r_shardmap"]],
                               [float(r1), float(r2)], rtol=RESIDUAL_RTOL)
    assert got["cg_converged"] and mon.converged()
    assert abs(got["cg_iterations"] - mon.iteration_count()) <= F32_ITERATIONS
    assert got["bicgstab_converged"] == mon4.converged()
    assert got["bicg_converged"] == mon5.converged()
    assert got["amg_converged"] == mon6.converged()
    assert abs(got["amg_iterations"] - mon6.iteration_count()) <= F32_ITERATIONS
    assert got["sharded_amg_converged"] == mon7.converged()
    assert abs(got["sharded_amg_iterations"] - mon7.iteration_count()) <= F32_ITERATIONS
    assert got["fine_impl"] == getattr(Mpd.levels[0].Aop, "impl", "?") == "via_dia_sharded"
    # the scattered plan is held to the oracle (the JAX example prints
    # 5.26e-07 at full size; its Pallas plan alone would take 4 s here)
    assert got["scattered_err"] <= 1e-5


def check_07(capsys):
    from cusp_autotuned_tpu.backend.reference import from_scipy, reference_spmv
    from cusp_autotuned_tpu.gallery.suite import williams_suite
    from cusp_autotuned_tpu.kernels.variants import build_spmv
    scale = 0.01
    # the JAX example's plain path and the one rail it runs on both
    # matrices (every Pallas rail in interpret mode would take seconds)
    configs = {"segsum": {"impl": "segsum"},
               "colsort2": {"impl": "colsort2", "vrow_planes": 1, "mix_chunks": 4}}
    suite = williams_suite(scale=scale)
    want = {}
    for name in ("FEM/Cantilever", "Webbase"):
        A = from_scipy(suite[name].tocoo().astype(np.float32), "csr")
        x = np.linspace(-1, 1, A.num_cols).astype(np.float32)
        ref = reference_spmv(A, x)
        for impl, cfg in configs.items():
            y = np.asarray(jax.jit(build_spmv(A, cfg))(jnp.asarray(x)))
            want[f"{name} {impl}"] = np.linalg.norm(y - ref) / np.linalg.norm(ref)
    got, _ = port_example("07_spmv_strategies", capsys, scale=scale)
    assert set(got["errors"]) == {f"{n} {i}" for n in ("FEM/Cantilever", "Webbase")
                                  for i in ("segsum", "binned", "colsort",
                                            "colsort2", "routed")}
    ran = {k: v for k, v in got["errors"].items() if v is not None}
    assert set(want) <= set(ran)
    assert max(ran.values()) <= 1e-5 and max(want.values()) <= 1e-5


def check_08(capsys):
    from cusp_autotuned_tpu.operators import planned_operator
    n = 40
    A = jgallery.poisson9pt(n, n, format="csr", dtype=np.float32)
    op = planned_operator(A, {"impl": "binned", "block_entries": 4096,
                              "col_window": 2048, "row_window": 512})
    b = np.ones(A.num_rows, np.float32)
    _, mon = jsolvers.cg(op, b, monitor=jsolvers.Monitor(b, 2000, 1e-5))
    y = jautotune.tuned_operator(A)(b)
    got, _ = port_example("08_large_operators", capsys, n=n, n_large=50)
    assert got["converged"] and mon.converged()
    assert abs(got["iterations"] - mon.iteration_count()) <= F32_ITERATIONS
    np.testing.assert_allclose(got["y_norm"], float(np.linalg.norm(y)),
                               rtol=RESIDUAL_RTOL)
    assert got["large_finite"]


def check_09(capsys):
    from cusp_autotuned_tpu.operators import make_linear_operator
    want = jax_example("09_matrix_free_and_assembly", capsys)
    got, printed = port_example("09_matrix_free_and_assembly", capsys)
    assert printed.split("Solver will")[0] == want.split("Solver will")[0]
    assert got["unique_entries"] == 6 and got["converged"]
    assert got["true_residual"] <= 1e-3
    assert float(re.search(r"true residual: (\S+)", want).group(1)) <= 1e-3

    # the same matrix-free CG in f64 in both packages
    nx = ny = 64

    def laplacian_apply(x):
        u = x.reshape(nx, ny)
        y = 4.0 * u
        y = y.at[1:, :].add(-u[:-1, :])
        y = y.at[:-1, :].add(-u[1:, :])
        y = y.at[:, 1:].add(-u[:, :-1])
        y = y.at[:, :-1].add(-u[:, 1:])
        return y.reshape(nx * ny)

    b = np.ones(nx * ny, np.float64)
    xj, mon = jsolvers.cg(make_linear_operator(laplacian_apply, shape=(nx * ny,) * 2),
                          b, monitor=jsolvers.Monitor(b, 400, 1e-6))
    true = np.linalg.norm(b - np.asarray(laplacian_apply(jnp.asarray(xj))))
    capsys.readouterr()
    f64 = examples.load("09_matrix_free_and_assembly").matrix_free_cg(
        nx, ny, device="cpu", dtype=torch.float64)
    assert f64["iterations"] == mon.iteration_count()
    assert abs(got["iterations"] - f64["iterations"]) <= F32_ITERATIONS
    np.testing.assert_allclose(f64["true_residual"], true / np.linalg.norm(b),
                               rtol=RESIDUAL_RTOL)


CHECKS = {"01_formats_and_convert": check_01, "02_solve_poisson": check_02,
          "03_amg_preconditioner": check_03, "04_autotuned_spmv": check_04,
          "05_graph_and_io": check_05, "06_multichip": check_06,
          "07_spmv_strategies": check_07, "08_large_operators": check_08,
          "09_matrix_free_and_assembly": check_09}


@pytest.mark.parametrize("name", examples.NAMES)
def test_example_matches_the_jax_example(name, capsys, fresh_tuners):
    CHECKS[name](capsys)
