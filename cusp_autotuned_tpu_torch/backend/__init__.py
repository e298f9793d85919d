from cusp_autotuned_tpu_torch.backend.reference import (
    to_scipy, from_scipy, reference_spmv, reference_spgemm,
)
