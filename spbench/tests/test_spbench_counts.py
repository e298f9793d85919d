"""Each cell's operations and bytes, counted from shapes."""

import pytest

from spbench import counts, stencils
from spbench.tests.conftest import load_config

NNZ = {"hpcg_27pt_testcg": 449_455_096, "Laplacian_3pt": 2_999_998,
       "Laplacian_5pt": 4_996_000, "Laplacian_7pt": 6_940_000,
       "Laplacian_9pt": 8_988_004, "Laplacian_27pt": 26_463_592}


@pytest.mark.parametrize("config", ["hpcg_testcg_256", "cusp_laplacians"])
def test_nnz_from_shapes(config):
    for spec in load_config(config)["matrices"]:
        assert stencils.nnz_of(spec["grid"], stencils.points(spec)) == NNZ[spec["name"]]


def test_hpcg_solve():
    n, nnz = 256 ** 3, 766 ** 3
    assert nnz == NNZ["hpcg_27pt_testcg"]
    flops = counts.cg_solve_flops(nnz, n, 11)
    assert flops == 11 * (2 * nnz + 12 * n) + 2 * nnz + n
    assert 13.0e9 < flops < 13.1e9
    # one f64 SpMV: every value once, x and y once
    assert counts.multiply_bytes(nnz, n, n, 1, 8) == (nnz + 2 * n) * 8
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    bound = counts.bound_s(counts.multiply_flops(nnz, 1),
                           counts.multiply_bytes(nnz, n, n, 1, 8), peak, "float64")
    assert bound == pytest.approx(3.8641e9 / 3.35e12, rel=1e-4)


@pytest.mark.parametrize("k,flops,bytes_", [(1, 100_775_188, 241_550_376),
                                            (3, 302_325_564, 321_550_376)])
def test_laplace_round(k, flops, bytes_):
    specs = load_config("cusp_laplacians")["matrices"]
    assert sum(counts.multiply_flops(NNZ[s["name"]], k) for s in specs) == flops
    assert sum(counts.multiply_bytes(NNZ[s["name"]], 10 ** 6, 10 ** 6, k, 4)
               for s in specs) == bytes_


def test_unknown_card_has_no_peaks():
    assert counts.peaks("cpu") is None
