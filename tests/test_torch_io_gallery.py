"""The port's io and the rest of its gallery against the JAX package's, on
the CPU.

Files go both ways: each package reads what the other wrote, and the
port's MatrixMarket, DIMACS and raw cusp-binary writers write the JAX
package's bytes (an .npz archive stamps its members with the time they
were written, so those are compared member by member).  grid2d, grid3d and
diffusion (FE and FD) build the JAX package's matrices: the same pattern,
values within f32 rtol 1e-6.  The cases of tests/test_io_gallery.py; the
reference's fixture zoo is not on this host, so the tests write their own
files."""

import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cusp_autotuned_tpu import gallery as jgallery, io as jio
from cusp_autotuned_tpu.backend.reference import to_scipy as jto_scipy

import cusp_autotuned_tpu_torch as ct
from cusp_autotuned_tpu_torch import gallery, io as pio
from cusp_autotuned_tpu_torch.backend.reference import to_scipy

from tests.torch_parity import one_thread, port_of  # noqa: F401
from tests.util import ALL_FORMATS, build, example_matrices


def _same_matrix(port, jax_c, rtol=0.0):
    assert port.shape == tuple(jax_c.shape) and port.nnz == jax_c.nnz
    np.testing.assert_allclose(to_scipy(port).toarray(),
                               np.asarray(jto_scipy(jax_c).todense()), rtol=rtol)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_matrix_market_bytes_and_both_directions(tmp_path, fmt):
    S = example_matrices()["rand50x40"]
    JA = build(S, fmt)
    A = port_of(JA)
    pio.write_matrix_market_file(A, tmp_path / "p.mtx", comment="x")
    jio.write_matrix_market_file(JA, tmp_path / "j.mtx", comment="x")
    assert (tmp_path / "p.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    back = pio.read_matrix_market_file(tmp_path / "j.mtx", format=fmt, device="cpu")
    jback = jio.read_matrix_market_file(tmp_path / "p.mtx", format=fmt)
    assert back.format == fmt and back.device.type == "cpu"
    _same_matrix(back, jback)
    np.testing.assert_allclose(to_scipy(back).toarray(), S.toarray(), rtol=1e-6)


def test_matrix_market_stream_and_dtype():
    S = example_matrices()["small4x4"]
    buf, jbuf = io.BytesIO(), io.BytesIO()
    pio.write_matrix_market_stream(port_of(build(S, "coo")), buf)
    jio.write_matrix_market_stream(build(S, "coo"), jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    A = pio.read_matrix_market_stream(buf, format="csr", dtype=np.float32, device="cpu")
    assert A.dtype == torch.float32 and A.format == "csr"
    np.testing.assert_array_equal(to_scipy(A).toarray(), S.toarray())
    # a dense tensor writes as the JAX package writes its array
    d, jd = io.BytesIO(), io.BytesIO()
    pio.write_matrix_market_stream(torch.as_tensor(S.toarray()), d)
    jio.write_matrix_market_stream(S.toarray(), jd)
    assert d.getvalue() == jd.getvalue()


@pytest.mark.parametrize("fmt", ["coo", "csr", "hyb"])
def test_binary_npz_both_directions(tmp_path, fmt):
    S = example_matrices()["widerow"]
    JA = build(S, fmt)
    pio.write_binary_file(port_of(JA), tmp_path / "p.npz")
    jio.write_binary_file(JA, tmp_path / "j.npz")
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for key in p.files:
            np.testing.assert_array_equal(p[key], j[key])
            assert p[key].dtype == j[key].dtype
    back = pio.read_binary_file(tmp_path / "j.npz", device="cpu")
    assert back.format == fmt
    _same_matrix(back, jio.read_binary_file(tmp_path / "p.npz"))


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_cusp_binary_bytes_and_both_directions(fmt):
    S = example_matrices()["tri37"]
    JA = build(S, fmt)
    for kw in ({}, dict(index_dtype=np.int64, value_dtype=np.float64)):
        buf, jbuf = io.BytesIO(), io.BytesIO()
        pio.write_cusp_binary_stream(port_of(JA), buf, **kw)
        jio.write_cusp_binary_stream(JA, jbuf, **kw)
        assert buf.getvalue() == jbuf.getvalue()
        buf.seek(0)
        jbuf.seek(0)
        back = pio.read_cusp_binary_stream(jbuf, format=fmt, device="cpu", **kw)
        _same_matrix(back, jio.read_cusp_binary_stream(buf, format=fmt, **kw))
    with pytest.raises(ValueError):
        pio.read_cusp_binary_stream(io.BytesIO(b"\x00" * 5), device="cpu")


@pytest.mark.parametrize("fmt", ["coo", "csr", "ell"])
def test_dimacs_bytes_and_both_directions(tmp_path, fmt):
    S = example_matrices()["small4x4"]
    JA = build(S, fmt)
    pio.write_dimacs_file(port_of(JA), tmp_path / "p.dimacs")
    jio.write_dimacs_file(JA, tmp_path / "j.dimacs")
    assert (tmp_path / "p.dimacs").read_bytes() == (tmp_path / "j.dimacs").read_bytes()
    back = pio.read_dimacs_file(tmp_path / "j.dimacs", format=fmt, device="cpu")
    _same_matrix(back, jio.read_dimacs_file(tmp_path / "p.dimacs", format=fmt))


def test_dimacs_terminals_and_errors():
    text = "c max flow\np max 4 3\nn 1 s\nn 4 t\na 1 2 3.5\na 2 4 1\na 3 4\n"
    A, ends = pio.read_dimacs_stream(io.StringIO(text), return_terminals=True,
                                     device="cpu")
    JA, jends = jio.read_dimacs_stream(io.StringIO(text), return_terminals=True)
    assert ends == jends == (0, 3)
    _same_matrix(A, JA)
    for bad in ("a 1 2 1\n", "p max 2 1\na 1 3 1\n"):
        with pytest.raises(ct.utils.IOException):
            pio.read_dimacs_stream(io.StringIO(bad), device="cpu")


@pytest.mark.parametrize("generator,args", [
    ("grid2d", (5, 4)), ("grid3d", (3, 4, 2)),
    ("diffusion", (6, 5, 1e-5, 0.7, "FE")), ("diffusion", (6, 5, 1e-2, 0.3, "FD"))])
@pytest.mark.parametrize("fmt", ["csr", "coo", "dia"])
def test_grid_and_diffusion_match_jax(generator, args, fmt):
    A = getattr(gallery, generator)(*args, format=fmt, device="cpu")
    JA = getattr(jgallery, generator)(*args, format=fmt)
    assert A.format == fmt and A.dtype == torch.float32
    _same_matrix(A, JA, rtol=1e-6)


def test_grid_and_diffusion_cases():
    """tests/test_io_gallery.py:75's checks on the port."""
    G = gallery.grid2d(4, 4, device="cpu")
    assert G.shape == (16, 16)
    assert to_scipy(G).sum() == 2 * (2 * 4 * 3)
    G3 = gallery.grid3d(3, 3, 3, format="coo", device="cpu")
    assert G3.nnz == to_scipy(G3).nnz and G3.shape == (27, 27)
    for method in (gallery.FE, gallery.FD):
        D = to_scipy(gallery.diffusion(5, 5, method=method, device="cpu")).toarray()
        np.testing.assert_allclose(D, D.T, atol=1e-6)
    with pytest.raises(ct.InvalidInputException):
        gallery.diffusion(4, 4, method="XX", device="cpu")
    assert sp.issparse(to_scipy(gallery.diffusion(3, 3, device="cpu")))
