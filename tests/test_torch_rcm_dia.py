"""The port's rcm_dia impl against the JAX package's, on the CPU.

rcm_dia reorders a square matrix by symmetric RCM, lays it out as DIA and
runs the inner DIA impl between two permutations of the vector
(cusp_autotuned_tpu/kernels/variants.py:206-229).  On the same f32 inputs
its SpMV is within 1e-5 of the JAX package's, it sits in the csr, ell and
ellr walks where the JAX package puts it (tests/test_autotune.py:161-170:
it validates on tri37), it refuses a non-square matrix, and the cost model
prices it as via_dia."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu.kernels.variants import build_spmv as jax_build_spmv

from cusp_autotuned_tpu_torch import gallery
from cusp_autotuned_tpu_torch.autotune import ResultStatus, Tuner
from cusp_autotuned_tpu_torch.autotune.cost_model import label_of, model_order_key
from cusp_autotuned_tpu_torch.autotune.tuner import configurations_for
from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv, to_scipy
from cusp_autotuned_tpu_torch.kernels import build_spmv
from cusp_autotuned_tpu_torch.kernels.variants import tuning_space
from cusp_autotuned_tpu_torch.operators import planned_operator
from cusp_autotuned_tpu_torch.ops.convert import convert
from cusp_autotuned_tpu_torch.utils.exceptions import FormatConversionException

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import build, example_matrices

RTOL = 1e-5


def _scrambled(n, seed):
    """poisson5pt n x n f32 under a seeded random symmetric permutation."""
    p = np.random.RandomState(seed).permutation(n * n)
    S = to_scipy(gallery.poisson5pt(n, n, format="csr", device="cpu")).tocsr()
    return S[p][:, p].tocoo()


@pytest.mark.parametrize("fmt", ["csr", "ell", "ellr"])
@pytest.mark.parametrize("dia_impl", ["slices", "gather"])
def test_rcm_dia_spmv_matches_jax(fmt, dia_impl):
    S = _scrambled(9, 2)
    J = build(S, fmt)
    A = port_of(J)
    x = np.random.RandomState(3).uniform(-1, 1, S.shape[1]).astype(np.float32)
    cfg = {"impl": "rcm_dia", "dia_impl": dia_impl}
    got = build_spmv(A, cfg)(torch.from_numpy(x))
    want = np.asarray(jax_build_spmv(J, cfg)(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), S @ x, rtol=RTOL, atol=1e-5)


def test_rcm_dia_plans_a_narrow_band():
    """The scrambled grid's DIA layout is refused by the fill guard; after
    RCM it is a band of at most 2n + 1 diagonals."""
    S = _scrambled(40, 0)
    A = from_scipy(S, "csr", device="cpu")
    with pytest.raises(FormatConversionException):
        build_spmv(A, {"impl": "via_dia", "dia_impl": "slices"})
    op = planned_operator(A, {"impl": "rcm_dia", "dia_impl": "slices"})
    assert op.impl == "rcm_dia"
    x = torch.linspace(-1, 1, A.num_cols)
    np.testing.assert_allclose(op(x).numpy(), S @ x.numpy(), rtol=RTOL, atol=1e-5)


def test_rcm_dia_refuses_a_non_square_matrix():
    A = from_scipy(sp.random(30, 40, density=0.1, random_state=0, dtype=np.float32),
                   "csr", device="cpu")
    with pytest.raises(FormatConversionException, match="square"):
        build_spmv(A, {"impl": "rcm_dia", "dia_impl": "slices"})


@pytest.mark.parametrize("fmt", ["csr", "ell", "ellr", "coo", "hyb"])
def test_rcm_dia_in_the_walks_as_in_jax(fmt):
    A = convert(gallery.poisson5pt(8, 8, format="csr", device="cpu"), fmt)
    impls = tuning_space(A).parameters[0].values
    if fmt in ("coo", "hyb"):
        assert "rcm_dia" not in impls
        return
    assert impls.index("rcm_dia") == impls.index("via_dense") + 1
    rcm = [c for c in configurations_for(A) if c["impl"] == "rcm_dia"]
    assert sorted((c["dia_impl"], c["block_size"]) for c in rcm) == \
        [("cuda", 128), ("cuda", 256), ("cuda", 512), ("slices", 0)]


def test_format_selection_moves_validate_on_tri37():
    """via_dia and rcm_dia validate on a banded CSR matrix
    (tests/test_autotune.py:161-170)."""
    A = from_scipy(example_matrices()["tri37"], "csr", device="cpu")
    x = torch.from_numpy(np.linspace(-1, 1, 37).astype(np.float32))
    results = Tuner(measure=False).tune(A, x, reference_computation=reference_spmv)
    ok = {r.configuration["impl"] for r in results if r.status == ResultStatus.Ok}
    assert {"segsum", "via_dia", "rcm_dia"} <= ok


def test_cost_model_prices_rcm_dia_as_via_dia():
    A = gallery.poisson5pt(30, 30, format="csr", device="cpu")
    assert label_of(A, {"impl": "rcm_dia"}) == "via_dia"
    assert label_of(A, {"impl": "rcm_dia", "value_dtype": "bfloat16"}) == "via_dia_bf16"
    key = model_order_key(A)
    assert key({"impl": "rcm_dia"}) == key({"impl": "via_dia"})
    order = [c["impl"] for c in sorted(configurations_for(A), key=key)]
    assert order.index("via_dia") < order.index("rcm_dia")
