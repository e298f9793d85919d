// Windowed CSR SpMV with x staged in shared memory:
// y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]] for the rows
// of at most thr entries; longer rows are left to the colsort2 tail.
//
// Replaces the JAX package's routed Pallas kernel at its SpMV site,
// _routed_kernel (kernels/pallas_routed.py:426, launched at K = 0 from
// :661).  On the TPU a block routes x through consecutive 16,384-column
// windows with two in-lane takes around a transpose, because the vector
// unit gathers only within a lane; hub rows and blocks that the takes
// cannot fill go to a colsort2 tail sub-plan.  Hopper gathers natively, so
// what carries over is the idea, x reaching the products through a small
// fast memory one column window at a time:
//
//   * a block of R threads owns R consecutive rows, a thread per row.  The
//     host plan lists, for each row block, the windows of W columns that
//     hold at least W / 8 of its entries (a staged window costs 4 W bytes
//     of x read once, about what W / 8 gathered 32-byte sectors cost);
//   * the block walks its staged windows in order: it loads x[w W, (w+1) W)
//     into shared memory with coalesced loads, and each thread adds its
//     row's entries of that window, read from shared memory;
//   * entries in windows the plan did not stage are read from x directly
//     (through L2), in the same pass: each thread keeps a cursor into its
//     row, whose column indices are sorted, so it adds its entries in
//     column order, window by window, whichever way x reaches them.  This
//     takes the place of the JAX rail's under-filled blocks, which it
//     ships to the tail;
//   * rows above thr (the hub rows) are skipped here; the colsort2 hub
//     kernels (colsort2_spmv.cu) write them into the same y, so y is the
//     main part plus the tail as one result.
//
// Each row of y is written exactly once: no atomics, the same result on
// every run.  Bound by bytes: per entry a value and a column index, x once
// per staged window and row block plus the directly gathered entries
// (through L2), two indptr reads per row and y once.  Shared memory is
// W * sizeof(x) bytes, up to 128 KB (16,384 f64), above the default 48 KB.
#include "common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxSmem = 128 * 1024;

template <typename Store, typename Acc>
__global__ void routed_spmv_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y, int m, int n, int thr,
                                   const int* __restrict__ win_ptr,
                                   const int* __restrict__ win_ids, int W) {
  extern __shared__ unsigned char smem_raw[];
  Acc* xs = reinterpret_cast<Acc*>(smem_raw);
  const int rb = blockIdx.x;
  const long long r = static_cast<long long>(rb) * blockDim.x + threadIdx.x;
  int p = 0, stop = 0;
  bool own = false;
  if (r < m) {
    p = indptr[r];
    stop = indptr[r + 1];
    own = stop - p <= thr;
  }
  if (!own) stop = p;                 // a hub row or no row: nothing to walk
  Acc acc = 0;
  for (int wi = win_ptr[rb]; wi < win_ptr[rb + 1]; ++wi) {
    const int c0 = win_ids[wi] * W;
    const int width = min(W, n - c0);
    for (; p < stop && col[p] < c0; ++p) acc += to_acc<Acc>(val[p]) * x[col[p]];
    __syncthreads();                  // the previous window is consumed
    for (int i = threadIdx.x; i < width; i += blockDim.x) xs[i] = x[c0 + i];
    __syncthreads();
    for (; p < stop && col[p] < c0 + width; ++p)
      acc += to_acc<Acc>(val[p]) * xs[col[p] - c0];
  }
  for (; p < stop; ++p) acc += to_acc<Acc>(val[p]) * x[col[p]];
  if (own) y[r] = acc;
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val, const void* x,
           void* y, int m, int n, int thr, const void* win_ptr,
           const void* win_ids, int W, int block, void* stream) {
  const long long smem = static_cast<long long>(W) * sizeof(Acc);
  if (W < 1 || smem > kMaxSmem || block % 32 != 0 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // once per instantiation, before any capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_spmv_kernel<Store, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long blocks = (static_cast<long long>(m) + block - 1) / block;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  routed_spmv_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block,
                                   static_cast<size_t>(smem),
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const Acc*>(x),
      static_cast<Acc*>(y), m, n, thr, static_cast<const int*>(win_ptr),
      static_cast<const int*>(win_ids), W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_routed_spmv_f32(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int n, int thr,
                         const void* win_ptr, const void* win_ids, int W,
                         int block, void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, n, thr, win_ptr,
                              win_ids, W, block, stream);
}

int cusp_routed_spmv_bf16(const void* indptr, const void* col, const void* val,
                          const void* x, void* y, int m, int n, int thr,
                          const void* win_ptr, const void* win_ids, int W,
                          int block, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, n, thr,
                                      win_ptr, win_ids, W, block, stream);
}

int cusp_routed_spmv_f64(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int n, int thr,
                         const void* win_ptr, const void* win_ids, int W,
                         int block, void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, n, thr, win_ptr,
                                win_ids, W, block, stream);
}

}  // extern "C"
