"""SpMV variant registry and per-format tuning spaces (counterpart of
cusp_autotuned_tpu/kernels/variants.py).

Every variant is a function build(A, config) -> fn(x) -> y.  The port's
impls:

  dia         slices (plain shifted slices), gather (plain masked gather),
              cuda (csrc/dia_spmv.cu; csrc/dia_spmm.cu for a block x)
  csr, coo    segsum (plain gather + index_add_)
  ell         gather (plain slot gather)
  ellr        rowlen (plain slot gather masked by row_lengths), gather
  hyb         default (plain ELL pass + COO pass)
  and, for csr/coo/ell/ellr/hyb:
              via_dia (re-lay the matrix out as DIA and run the inner DIA
              impl `dia_impl`), rcm_dia (csr/ell/ellr: reorder the square
              matrix by symmetric RCM, then via_dia's DIA impl between two
              permutations of the vector), via_dense (densify,
              torch.matmul), cuda
              (the matrix's entries planned as CSR in nnz-balanced tiles
              for csrc/csr_spmv.cu, vectors only), binned (csrc/binned_spmv.cu and, for a dense
              block x (n, k), csrc/binned_spmm.cu), colsort
              (csrc/coo_spmv.cu, csrc/coo_spmm.cu), colsort2 (virtual rows
              in K planes and a degree-sorted hub region,
              csrc/colsort2_spmv.cu, csrc/colsort2_spmm.cu), routed (the
              rows walked as colsort2's main rows in one plane, with a
              colsort2 tail for the hub rows, csrc/routed_spmv.cu,
              csrc/routed_spmm.cu)
  and the explicit baseline `cusparse` (csr/coo/ell/ellr/hyb, as the JAX
  package's `bcoo`): torch.sparse CSR, cuSPARSE on the card
  (backend/tsparse.py).  It is no port of a Pallas kernel and stands in no
  tuning space, default configuration or cost model.

`cuda` stands where the JAX package has `pallas`.  For a matrix on a CUDA
device the default impl is `cuda` (for a block x, `binned` except on dia),
and via_dia's default `dia_impl` is `cuda`; on the CPU the defaults are the
plain paths, as in the reference.  The SpMM kernels take no axis of their
own: `block_size` and the plans' axes apply to both shapes of x.
The tuning spaces mirror the JAX package's with Hopper axes in place of
its TPU axes (VMEM windows, lanes, int16 packing): `block_size`,
`threads_per_row`, `values_per_thread`, `vrow_planes` and `vrow_len`
(colsort2); routed takes only the block (the JAX rail's `window` is a
VMEM axis: every x is read through L1/L2 here).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from cusp_autotuned_tpu_torch.autotune.space import TuningSpace
from cusp_autotuned_tpu_torch.kernels.binned import build_binned
from cusp_autotuned_tpu_torch.kernels.colsort import build_colsort
from cusp_autotuned_tpu_torch.kernels.colsort2 import build_colsort2
from cusp_autotuned_tpu_torch.kernels.dia import promoted
from cusp_autotuned_tpu_torch.kernels.routed import build_routed
from cusp_autotuned_tpu_torch.utils.config import get_config, plan_value_dtype
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, NotImplementedException,
)


def _build_dia_slices(A, config):
    from cusp_autotuned_tpu_torch.ops.multiply import spmv_dia
    # value_dtype holds on the plain path too: bf16 data is widened to x's
    # dtype before each product
    store = plan_value_dtype(config, A.dtype)
    if store != A.dtype:
        A = dataclasses.replace(A, data=A.data.to(store))

    def fn(x):
        return spmv_dia(A, x)
    return fn


def _build_dia_gather(A, config):
    """One masked gather of x for every (diagonal, row) slot."""
    m, n = A.shape
    idx = (torch.arange(A.rows_padded, device=A.device)[None, :]
           + torch.tensor(A.offsets, device=A.device)[:, None])
    valid = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)

    def fn(x):
        x = promoted(A.data, x)
        xg = torch.index_select(x, 0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])
        data, mask = A.data.to(x.dtype), valid
        if x.dim() == 2:
            data, mask = data[..., None], mask[..., None]
        return torch.where(mask, data * xg, 0).sum(0)[:m]
    return fn


def _plain(spmv_name):
    def build(A, config):
        import importlib
        spmv = getattr(importlib.import_module("cusp_autotuned_tpu_torch.ops.multiply"),
                       spmv_name)

        def fn(x):
            return spmv(A, x)
        return fn
    return build


def _build_cusparse(A, config):
    """The vendor-library baseline (backend/tsparse.py): explicit
    configurations only, never part of the tuning walk."""
    from cusp_autotuned_tpu_torch.backend.tsparse import cusparse_spmv
    return cusparse_spmv(A)


def _build_cuda(format_name):
    def build(A, config):
        from cusp_autotuned_tpu_torch.kernels import pallas_spmv
        return pallas_spmv.build(format_name, A, config)
    return build


def _inner_dia_impl(config, D):
    """Inner DIA impl for via_dia: an explicit dia_impl wins; otherwise the
    kernel for a matrix on a CUDA device, the plain slices on the CPU."""
    d = config.get("dia_impl")
    if d not in (None, "none", 0):
        return d
    return "cuda" if D.device.type == "cuda" else "slices"


def _build_via_dia(A, config):
    """Format-selection move: re-lay the matrix out as DIA (distinct col-row
    deltas become diagonals) and run a DIA impl.  The conversion's fill
    guard rejects patterns with too many diagonals."""
    from cusp_autotuned_tpu_torch.ops.convert import convert
    D = convert(A, "dia")
    fn = build_spmv(D, {**config, "impl": _inner_dia_impl(config, D)})
    fn.plan_stats = {"impl": "via_dia"}
    return fn


def _build_rcm_dia(A, config):
    """Format-selection move: reorder the square matrix by symmetric RCM to
    shrink its band (graph.symmetric_rcm), lay the reordered matrix out as
    DIA and run the inner DIA impl between two permutations of the vector,

        y = P^T (D (P x)),   D = P A P^T,

    each permutation one index_select."""
    from cusp_autotuned_tpu_torch.graph.ordering import symmetric_rcm
    from cusp_autotuned_tpu_torch.ops.convert import convert, coo_arrays
    from cusp_autotuned_tpu_torch.formats.coo import coo_matrix
    if A.shape[0] != A.shape[1]:
        raise FormatConversionException(
            "rcm_dia requires a square matrix (symmetric permutation)")
    perm = symmetric_rcm(A).perm.long()
    inv = torch.argsort(perm)
    row, col, val, shape = coo_arrays(A)
    inv_h = inv.cpu().numpy()
    D = convert(coo_matrix(inv_h[row], inv_h[col], val, shape, device=A.device),
                "dia")
    inner = build_spmv(D, {**config, "impl": _inner_dia_impl(config, D)})

    def fn(x):
        return torch.index_select(inner(torch.index_select(x, 0, perm)), 0, inv)

    fn.plan_stats = {"impl": "rcm_dia"}
    return fn


def _build_via_dense(A, config):
    """Format-selection move: densify and run one dense product.  Viable
    when the matrix fills at least a quarter of its dense form and that
    form holds at most 32 MB, the JAX package's guard; otherwise the
    skippable conversion failure, like via_dia's fill guard."""
    from cusp_autotuned_tpu_torch.backend.reference import to_scipy
    m, n = A.shape
    dense_bytes = m * n * A.dtype.itemsize
    fill = A.nnz / max(m * n, 1)
    if fill < 0.25 or dense_bytes > (32 << 20):
        raise FormatConversionException(
            f"via_dense needs fill >= 0.25 and <= 32 MB dense data "
            f"(fill {fill:.3f}, {dense_bytes >> 20} MB)")
    D = torch.tensor(to_scipy(A).toarray(), dtype=A.dtype, device=A.device)

    def fn(x):
        x = promoted(D, x)
        return torch.matmul(D.to(x.dtype), x)
    return fn


_MOVES = {"via_dia": _build_via_dia, "via_dense": _build_via_dense,
          "binned": build_binned, "colsort": build_colsort,
          "colsort2": build_colsort2, "routed": build_routed}

VARIANTS: Dict[str, Dict[str, Callable]] = {
    "dia": {"slices": _build_dia_slices, "gather": _build_dia_gather,
            "cuda": _build_cuda("dia")},
    "csr": {"segsum": _plain("spmv_csr"), **_MOVES, "rcm_dia": _build_rcm_dia,
            "cuda": _build_cuda("csr"), "cusparse": _build_cusparse},
    "coo": {"segsum": _plain("spmv_coo"), **_MOVES, "cuda": _build_cuda("coo"),
            "cusparse": _build_cusparse},
    "ell": {"gather": _plain("spmv_ell"), **_MOVES, "rcm_dia": _build_rcm_dia,
            "cuda": _build_cuda("ell"), "cusparse": _build_cusparse},
    "ellr": {"gather": _plain("spmv_ell"), "rowlen": _plain("spmv_ellr"),
             **_MOVES, "rcm_dia": _build_rcm_dia, "cuda": _build_cuda("ellr"),
             "cusparse": _build_cusparse},
    "hyb": {"default": _plain("spmv_hyb"), **_MOVES, "cuda": _build_cuda("hyb"),
            "cusparse": _build_cusparse},
}

_DEFAULTS = {
    "dia": {"impl": "slices"},
    "csr": {"impl": "segsum", "dia_impl": "none"},
    "coo": {"impl": "segsum", "dia_impl": "none"},
    "ell": {"impl": "gather", "dia_impl": "none"},
    "ellr": {"impl": "rowlen", "dia_impl": "none"},
    "hyb": {"impl": "default", "dia_impl": "none"},
}

# impls of each format's tuning walk (never `cusparse`: a baseline)
_RAILS = ("binned", "colsort", "colsort2", "routed")
_DIA_MOVES = ("via_dia", "rcm_dia")       # the impls with an inner `dia_impl`
_SPACE_IMPLS = {
    "csr": ("segsum", "via_dia", "via_dense", "rcm_dia", "cuda", *_RAILS),
    "coo": ("segsum", "via_dia", "via_dense", "cuda", *_RAILS),
    "ell": ("gather", "via_dia", "via_dense", "rcm_dia", "cuda", *_RAILS),
    "ellr": ("rowlen", "via_dia", "via_dense", "rcm_dia", "cuda", *_RAILS),
    "hyb": ("default", "via_dia", "cuda", "binned"),
}
BLOCK_SIZES = (128, 256, 512)             # the fork's BLOCK_SIZE axis
# colsort2 and routed take the two larger blocks
WIDE_BLOCKS = (256, 512)
# binned: 0 = binned by length (up to a warp a row); the nnz-balanced
# tiles of the `cuda` impl need no lanes-per-row axis
THREADS_PER_ROW = (0, 1, 4)
VALUES_PER_THREAD = (4, 8, 16)            # colsort: chunks of 128..512
VROW_PLANES = (1, 2, 4)                   # colsort2: K planes
VROW_LENS = (8, 32)                       # colsort2: entries of a virtual row


def default_config(A, x=None) -> Dict[str, Any]:
    """The untuned configuration: on a CUDA device a kernel, the plain path
    on the CPU.  For a vector x that is the `cuda` impl; for a dense block
    x (n, k) the DIA SpMM kernel for dia and the binned SpMM kernel for the
    other formats, since the CSR kernel (nnz-balanced tiles) takes vectors only,
    as the JAX package's `pallas` impl does.  A complex matrix takes the
    plain path on any device: the kernels take real values only."""
    cfg = dict(_DEFAULTS[A.format])
    if A.device.type == "cuda" and not A.dtype.is_complex:
        block = x is not None and x.dim() == 2
        cfg["impl"] = "binned" if block and A.format != "dia" else "cuda"
    return cfg


def tuning_space(A) -> TuningSpace:
    """The constrained tuning space of a matrix's format.  `impl` is the
    kernel strategy, including the format-selection moves; `dia_impl` the
    inner DIA impl of via_dia and rcm_dia; `block_size` the threads per
    block of every CUDA launch (for the `cuda` impl it also sets the tile,
    block_size * kernels/csr.py's ENTRIES_PER_THREAD entries); `threads_per_row`
    binned's lanes per row; `values_per_thread`
    colsort's chunk; `vrow_planes` and `vrow_len` colsort2's planes and
    virtual-row length; colsort2 and routed on blocks of 256 or 512
    threads (41 configurations for coo, 45 for csr, ell and ellr, whose
    walks take rcm_dia too).
    Constraints pin each axis to 0 or
    'none' where it does not apply, as the fork pins PREFETCH_TYPE.  The
    opt-in `value_dtype` axis (CUSP_TORCH_TUNE_BF16) adds bf16 storage to
    the DIA kernels."""
    fmt = A.format
    space = TuningSpace(parameters=[])
    search_bf16 = get_config().search_low_precision and A.dtype.itemsize == 4
    if fmt == "dia":
        space.add_parameter("impl", ("slices", "gather", "cuda"))
        space.add_parameter("block_size", (0, *BLOCK_SIZES))
        space.add_constraint(("impl", "block_size"),
                             lambda i, b: (b > 0) == (i == "cuda"))
        if search_bf16:
            space.add_parameter("value_dtype", ("none", "bfloat16"))
            space.add_constraint(("impl", "value_dtype"),
                                 lambda i, v: v == "none" or i in ("slices", "cuda"))
        return space
    if fmt not in _SPACE_IMPLS:
        raise NotImplementedException(f"no tuning space for format {fmt!r}")
    impls = _SPACE_IMPLS[fmt]
    space.add_parameter("impl", impls)
    space.add_parameter("dia_impl", ("none", "slices", "cuda"))
    space.add_parameter("block_size", (0, *BLOCK_SIZES))
    space.add_parameter("threads_per_row", THREADS_PER_ROW)
    space.add_constraint(("impl", "dia_impl"),
                         lambda i, d: (d == "none") == (i not in _DIA_MOVES))
    space.add_constraint(
        ("impl", "dia_impl", "block_size"),
        lambda i, d, b: (b > 0) == (i in ("cuda", *_RAILS) or d == "cuda"))
    space.add_constraint(("impl", "block_size"),
                         lambda i, b: i not in ("colsort2", "routed")
                         or b in WIDE_BLOCKS)
    space.add_constraint(("impl", "threads_per_row"),
                         lambda i, t: t == 0 or i == "binned")
    if "colsort" in impls:
        space.add_parameter("values_per_thread", (0, *VALUES_PER_THREAD))
        space.add_constraint(("impl", "values_per_thread"),
                             lambda i, v: (v > 0) == (i == "colsort"))
    if "colsort2" in impls:
        space.add_parameter("vrow_planes", (0, *VROW_PLANES))
        space.add_parameter("vrow_len", (0, *VROW_LENS))
        space.add_constraint(("impl", "vrow_planes"),
                             lambda i, k: (k > 0) == (i == "colsort2"))
        space.add_constraint(("impl", "vrow_len"),
                             lambda i, v: (v > 0) == (i == "colsort2"))
    if search_bf16:
        space.add_parameter("value_dtype", ("none", "bfloat16"))
        space.add_constraint(("impl", "value_dtype"),
                             lambda i, v: v == "none" or i in _DIA_MOVES)
    return space


def build_spmv(A, config: Dict[str, Any]) -> Callable:
    impl = config.get("impl") or default_config(A)["impl"]
    try:
        builder = VARIANTS[A.format][impl]
    except KeyError:
        raise NotImplementedException(
            f"no variant {impl!r} for format {A.format!r}") from None
    return builder(A, config)
