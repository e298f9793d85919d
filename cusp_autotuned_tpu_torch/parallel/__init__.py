"""Multi-device execution over a RowMesh (counterpart of
cusp_autotuned_tpu/parallel): row-sharded sparse operators, distributed
Krylov solves, and planned operators partitioned over the mesh, driven by
one process.  The reference is single-GPU (SURVEY.md §2.6); this is the
JAX package's multi-device extension, ported."""

from cusp_autotuned_tpu_torch.parallel.sharded import (
    RowMesh, make_row_mesh, shard_rows, shard_rows_aligned, replicate,
    distributed_cg, distributed_bicgstab, sharded_spmv,
    distribute_for_solve, distribute_multilevel,
)
from cusp_autotuned_tpu_torch.parallel.shard_map_spmv import (
    sharded_spmv_dia_shardmap, distributed_cg_shardmap, distributed_cg_halo,
    sharded_spmv_binned_shardmap, distributed_cg_binned,
    sharded_spmv_colsort_shardmap,
)
from cusp_autotuned_tpu_torch.parallel.sharded_plans import (
    ShardedPlannedOperator, shard_planned_dia, shard_planned_blocks,
)
