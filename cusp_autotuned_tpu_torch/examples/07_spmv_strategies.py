"""The unstructured SpMV strategy menu and the benchmark suite.

The tuner picks among kernel strategies per matrix (the fork's per-format
tuning spaces, cusp/system/cuda/ktt/*_multiply.h, reborn as Hopper
kernels):
  - segsum      gather and index_add_ (the plain path)
  - binned      rows binned by length: a lane a short row, a warp or a
                block a long one (csrc/binned_spmv.cu)
  - colsort     nnz-balanced chunks of the column-sorted entries with a
                carry fold (csrc/coo_spmv.cu)
  - colsort2    virtual rows in K planes and a degree-sorted hub region
                (csrc/colsort2_spmv.cu)
  - routed      colsort2's row walk in one plane, its hub rows through a
                colsort2 tail (csrc/routed_spmv.cu)
"""

import sys

import numpy as np
import torch

from cusp_autotuned_tpu_torch.backend.reference import from_scipy, reference_spmv
from cusp_autotuned_tpu_torch.gallery.suite import williams_suite
from cusp_autotuned_tpu_torch.kernels.variants import build_spmv
from cusp_autotuned_tpu_torch.utils.config import resolve_device
from cusp_autotuned_tpu_torch.utils.exceptions import (
    FormatConversionException, NotImplementedException,
)

STRATEGIES = (("segsum", {"impl": "segsum"}),
              ("binned", {"impl": "binned", "block_size": 256}),
              ("colsort", {"impl": "colsort", "values_per_thread": 4,
                           "block_size": 256}),
              ("colsort2", {"impl": "colsort2", "vrow_planes": 1}),
              ("routed", {"impl": "routed"}))


def main(device=None, scale=0.05):
    device = resolve_device(device)
    # a banded FEM-like matrix and a power-law graph from the suite stand-ins
    suite = williams_suite(scale=scale, names=("FEM/Cantilever", "Webbase"))
    errors = {}
    for name in ("FEM/Cantilever", "Webbase"):
        A = from_scipy(suite[name].tocoo().astype(np.float32), "csr", device=device)
        x = torch.linspace(-1, 1, A.num_cols, device=device)
        ref = reference_spmv(A, x)
        for impl, cfg in STRATEGIES:
            try:
                y = build_spmv(A, cfg)(x).double().cpu().numpy()
            except (FormatConversionException, NotImplementedException) as e:
                # a refused plan is part of the design, as in the tuner
                errors[f"{name} {impl}"] = None
                print(f"{name:16s} {impl:8s} skipped ({type(e).__name__})")
                continue
            err = float(np.linalg.norm(y - ref) / (np.linalg.norm(ref) or 1.0))
            errors[f"{name} {impl}"] = err
            print(f"{name:16s} {impl:8s} rel err {err:.2e}")

    print("\nfull sweep: python -m cusp_autotuned_tpu_torch.benchmarks.spmv_tiles")
    return {"errors": errors}


if __name__ == "__main__":
    main(*sys.argv[1:])
