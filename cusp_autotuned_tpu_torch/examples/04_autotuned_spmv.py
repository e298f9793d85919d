"""The KTT layer reborn: dynamic and offline SpMV autotuning
(reference: the fork's cusp/ktt API, testing/ktt.cu, main.cu)."""

import sys

import numpy as np
import torch

import cusp_autotuned_tpu_torch as ct
from cusp_autotuned_tpu_torch import autotune, gallery
from cusp_autotuned_tpu_torch.backend.reference import reference_spmv


def main(device=None, n=100_000):
    A = gallery.make_diagonal_symmetric_matrix(n, n, 3, 9, device=device)
    x = torch.as_tensor(np.random.RandomState(0).randn(A.num_cols).astype(np.float32),
                        device=A.device)

    # offline tuning with per-configuration validation against the oracle
    results = autotune.tune(A, x, reference_computation=reference_spmv)
    for r in results:
        print(f"  {r.status.value:20s} {r.duration_ms:10.3f} ms  "
              f"{r.configuration}")
    best = autotune.get_tuner().best_configuration(A)
    print("best configuration:", best)

    # dynamic mode: every multiply takes one tuning step until the space is
    # exhausted, then runs the best configuration
    autotune.enable()
    try:
        for _ in range(3):
            y = ct.multiply(A, x)
    finally:
        autotune.disable()

    # fixed configuration
    y = autotune.multiply(A, x, configuration=best)
    ref = reference_spmv(A, x)
    return {"statuses": [r.status.value for r in results], "best": best,
            "y_rel_err": float(np.linalg.norm(y.double().cpu().numpy() - ref)
                               / np.linalg.norm(ref))}


if __name__ == "__main__":
    main(*sys.argv[1:])
