// Row-binned CSR SpMM: Y[r, c] = sum_{e in [indptr[r], indptr[r+1])}
// val[e] * X[col[e], c], with X (n, k) and Y (m, k) row-major and contiguous.
//
// Replaces the JAX package's row-lane-binned Pallas SpMM kernel,
// _binned_spmm_kernel (kernels/pallas_binned.py:229, launched from :624),
// and the K > 0 use of the streamed site (:422, _streamed_kernel :274).
// Those read each (Bs, 128) entry block once and loop over the k columns
// held in VMEM.  The first kernel here was the reference's CSR x array2d
// block kernel: a team of T <= 32 lanes a row over a tile of T columns with
// 4-byte loads of X, every row's entries read again for each tile past 32
// columns, and a block a hub row whose teams added round robin.  Now it is
// csrc/rail_spmm.cuh's walk with one plane over the plan's walk list
// (kPerm): slot s walks row rows[s], its entries [bounds[s].x,
// bounds[s].y).  The list holds the rows of at most spmm_cap entries in the
// order of plan_bins' bins, the bins of most lanes a row first (by length
// with threads_per_row 0, so that rows of like length share a warp and the
// longest chains start first; row order with a fixed group).  A team of T
// lanes a row, C columns a lane with 16-byte loads and stores where k and
// the alignment allow (kernels/dia.py spmm_schedule), the warp's teams'
// entries loaded together each round.  spmm_cap is hub_cap, or the rails'
// threshold max(64, 4 nnz / m) where that is lower: a row the walk takes
// is a serial chain of its team, and a warp's teams wait on its longest
// (kernels/binned.py spmm_walk).  The longer rows are left to the colsort2
// hub pair (colsort2_spmm.cu), into the same Y.
//
// Each row's sum is serial in entry order from zero, whatever k, C, W, T or
// bin order: its Y equals the routed SpMM's at the same threshold bit for
// bit where the rows hold their columns in the same order.  Each walked row
// of Y is written once, by its team: no atomics, the same result on every
// run.  Bound by bytes: per entry a value and a column index, per walked row
// its id and bounds, the gathered rows of X (through L2), Y written once.
// Row and element offsets of X and Y are 64-bit.
#include "common.cuh"
#include "rail_spmm.cuh"

namespace {

template <typename Store, typename Acc, int W, int C>
__global__ void binned_spmm_walk_kernel(const int* __restrict__ col,
                                        const Store* __restrict__ val,
                                        const int* __restrict__ rows,
                                        const int2* __restrict__ bounds,
                                        const Acc* __restrict__ x,
                                        Acc* __restrict__ y, int slots, int k,
                                        int team_shift) {
  // every listed row is the walk's: no row is left to a threshold
  rail_spmm::walk<Store, Acc, W, C, true>(nullptr, col, val, rows, bounds, x, y,
                                          slots, k, rail_spmm::kNoPlanes, INT_MAX,
                                          team_shift);
}

template <typename Store, typename Acc>
int launch(const void* col, const void* val, const void* rows,
           const void* bounds, int slots, const void* x, void* y, int k,
           int width, int cols, int team_shift, int block, void* stream) {
  dim3 grid;
  if (slots < 0 ||
      !rail_spmm::grid_of(slots, k, cols, team_shift, block, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.x == 0) return 0;
  return with_width<Acc>(width, cols, [&](auto w, auto c) {
    binned_spmm_walk_kernel<Store, Acc, decltype(w)::value, decltype(c)::value>
        <<<grid, block, rail_spmm::smem_bytes<Acc>(block),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(col), static_cast<const Store*>(val),
            static_cast<const int*>(rows), static_cast<const int2*>(bounds),
            static_cast<const Acc*>(x), static_cast<Acc*>(y), slots, k,
            team_shift);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

int cusp_binned_spmm_f32(const void* col, const void* val, const void* rows,
                         const void* bounds, int slots, const void* x, void* y,
                         int k, int width, int cols, int team_shift, int block,
                         void* stream) {
  return launch<float, float>(col, val, rows, bounds, slots, x, y, k, width, cols,
                              team_shift, block, stream);
}

int cusp_binned_spmm_bf16(const void* col, const void* val, const void* rows,
                          const void* bounds, int slots, const void* x, void* y,
                          int k, int width, int cols, int team_shift, int block,
                          void* stream) {
  return launch<__nv_bfloat16, float>(col, val, rows, bounds, slots, x, y, k,
                                      width, cols, team_shift, block, stream);
}

int cusp_binned_spmm_f64(const void* col, const void* val, const void* rows,
                         const void* bounds, int slots, const void* x, void* y,
                         int k, int width, int cols, int team_shift, int block,
                         void* stream) {
  return launch<double, double>(col, val, rows, bounds, slots, x, y, k, width,
                                cols, team_shift, block, stream);
}

}  // extern "C"
