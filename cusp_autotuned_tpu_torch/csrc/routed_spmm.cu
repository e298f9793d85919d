// Routed CSR SpMM: Y[r, c] = sum_{e in [indptr[r], indptr[r+1])} val[e] *
// X[col[e], c] for the rows of at most thr entries, with X (n, k) and Y
// (m, k) row-major and contiguous; longer rows are left to the colsort2
// tail (colsort2_spmm.cu's hub pair, into the same Y).
//
// Replaces the JAX package's routed Pallas kernel at its SpMM site,
// _routed_kernel (kernels/pallas_routed.py:426, launched at K > 0 from
// :709).  On the TPU the rail routes X through column windows held in VMEM.
// The first kernel here staged such windows of X in shared memory, a thread
// a row over a 32-column tile with 4-byte loads; staging lost to reading
// through L1/L2 in the SpMV (routed_spmv.cu), and the thread-a-row layout
// left the loads narrow.  Now the kernel is csrc/rail_spmm.cuh's walk with
// one plane: a team of T lanes a row, C columns a lane with 16-byte loads
// and stores where k and the alignment allow (kernels/dia.py
// spmm_schedule), the warp's teams' entries loaded together each round,
// every row of X read through L1/L2.  So its Y equals the colsort2 SpMM's
// with one plane of thr entries bit for bit, whatever k, C or T.
//
// Each main row of Y is written once, by its team: no atomics, the same
// result on every run.  Bound by bytes: per entry a value and a column
// index, the gathered rows of X (through L2), Y written once.  Row and
// element offsets of X and Y are 64-bit.
#include "common.cuh"
#include "rail_spmm.cuh"

namespace {

template <typename Store, typename Acc, int W, int C>
__global__ void routed_spmm_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y, int m, int k, int thr,
                                   int team_shift) {
  rail_spmm::walk<Store, Acc, W, C, false>(indptr, col, val, nullptr, nullptr,
                                           x, y, m, k, rail_spmm::kNoPlanes, thr,
                                           team_shift);
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val, const void* x,
           void* y, int m, int k, int thr, int width, int cols, int team_shift,
           int block, void* stream) {
  dim3 grid;
  if (thr < 0 || !rail_spmm::grid_of(m, k, cols, team_shift, block, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.x == 0) return 0;
  return with_width<Acc>(width, cols, [&](auto w, auto c) {
    routed_spmm_kernel<Store, Acc, decltype(w)::value, decltype(c)::value>
        <<<grid, block, rail_spmm::smem_bytes<Acc>(block),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(indptr), static_cast<const int*>(col),
            static_cast<const Store*>(val), static_cast<const Acc*>(x),
            static_cast<Acc*>(y), m, k, thr, team_shift);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

int cusp_routed_spmm_f32(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int k, int thr, int width,
                         int cols, int team_shift, int block, void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, k, thr, width, cols,
                              team_shift, block, stream);
}

int cusp_routed_spmm_bf16(const void* indptr, const void* col, const void* val,
                          const void* x, void* y, int m, int k, int thr, int width,
                          int cols, int team_shift, int block, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, k, thr, width,
                                      cols, team_shift, block, stream);
}

int cusp_routed_spmm_f64(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int k, int thr, int width,
                         int cols, int team_shift, int block, void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, k, thr, width, cols,
                                team_shift, block, stream);
}

}  // extern "C"
