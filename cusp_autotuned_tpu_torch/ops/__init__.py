"""Verbs (counterpart of cusp_autotuned_tpu/ops): the same exports.  Note
that `multiply`, `convert`, `transpose` and `elementwise` here are the
functions, which shadow their modules' names: import a module by its full
path (importlib.import_module) where the module is meant."""

from cusp_autotuned_tpu_torch.ops import blas, format_utils
from cusp_autotuned_tpu_torch.ops.convert import convert, copy, to_dense
from cusp_autotuned_tpu_torch.ops.multiply import (
    multiply, generalized_spmv, generalized_spgemm,
)
from cusp_autotuned_tpu_torch.ops.transpose import transpose
from cusp_autotuned_tpu_torch.ops.elementwise import add, subtract, elementwise
from cusp_autotuned_tpu_torch.ops.sort import (
    counting_sort, counting_sort_by_key, sort_by_row, sort_by_row_and_column,
)
from cusp_autotuned_tpu_torch.ops.format_utils import (
    offsets_to_indices, indices_to_offsets, extract_diagonal,
    count_diagonals, compute_max_entries_per_row,
    compute_optimal_entries_per_row,
)
from cusp_autotuned_tpu_torch.ops.verify import (
    is_valid_matrix, assert_is_valid_matrix, assert_same_dimensions,
)
from cusp_autotuned_tpu_torch.ops.printing import print_matrix, spy, spy_svg
