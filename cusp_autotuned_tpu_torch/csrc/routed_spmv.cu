// Routed CSR SpMV, its rows walked by the shared row walk:
// y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]] for the rows
// of at most thr entries; longer rows are left to the colsort2 tail.
//
// Replaces the JAX package's routed Pallas kernel at its SpMV site,
// _routed_kernel (kernels/pallas_routed.py:426, launched at K = 0 from
// :661).  On the TPU a block routes x through consecutive 16,384-column
// windows with two in-lane takes around a transpose, because the vector
// unit gathers only within a lane; hub rows and blocks that the takes
// cannot fill go to a colsort2 tail sub-plan.  Hopper gathers natively
// from L1/L2, so neither the takes nor the windows carry over:
//
//   * the rows are walked by rail_rows.cuh, as colsort2's main rows with a
//     single plane: a lane a row of at most 32 entries, the warp's lanes
//     loading the rows' entries together (coalesced), and a warp for each
//     longer row.  The first version gave each row one thread, whose loads
//     of val and col did not coalesce, and on LP (2,000 rows of ~1,300
//     entries) left 124 of the card's 132 SMs idle;
//   * every x is read through L1/L2: copying x into shared memory, whole
//     column windows or the spans that a block's rows read densely, lost
//     to that on every matrix measured (by 14-26 % on FEM/Accelerator and
//     Epidemiology, where a span rule staged most; PERF.md);
//   * rows above thr (the hub rows) are skipped here; the colsort2 hub
//     kernels (colsort2_spmv.cu) write them into the same y, so y is the
//     main part plus the tail as one result.
//
// Each row of y is written exactly once: no atomics, the same result on
// every run.  Bound by bytes: per entry a value and a column index, the
// gathered x (through L2), two indptr reads per row and y once.  Shared
// memory: the warps' 4 B product slots (at most 32 KB of f64).
#include "rail_rows.cuh"

namespace {

constexpr int kMaxBlock = 1024;

template <typename Store, typename Acc>
__global__ void routed_spmv_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y, int m, int thr,
                                   const int* __restrict__ long_rows,
                                   int n_long, int short_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rail::rows_body<rail::kFullMode, Store, Acc>(
      indptr, col, val, x, y, m, thr, rail::kNoPlanes, long_rows, n_long,
      short_blocks, reinterpret_cast<Acc*>(smem_raw));
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val, const void* x,
           void* y, int m, int thr, const void* long_rows, int n_long, int block,
           void* stream) {
  if (block % 32 != 0 || block < 32 || block > kMaxBlock || thr < 1 || n_long < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int short_blocks = 0;
  const long long blocks = rail::grid_blocks(m, n_long, block, &short_blocks);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const size_t smem = sizeof(Acc) * rail::kAhead * static_cast<size_t>(block);
  routed_spmv_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const Acc*>(x),
      static_cast<Acc*>(y), m, thr, static_cast<const int*>(long_rows), n_long,
      short_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_routed_spmv_f32(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int thr,
                         const void* long_rows, int n_long, int block,
                         void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, thr, long_rows, n_long,
                              block, stream);
}

int cusp_routed_spmv_bf16(const void* indptr, const void* col, const void* val,
                          const void* x, void* y, int m, int thr,
                          const void* long_rows, int n_long, int block,
                          void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, thr, long_rows,
                                      n_long, block, stream);
}

int cusp_routed_spmv_f64(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int thr,
                         const void* long_rows, int n_long, int block,
                         void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, thr, long_rows,
                                n_long, block, stream);
}

}  // extern "C"
