// Windowed CSR SpMM with X staged in shared memory: Y[r, c] =
// sum_{e in [indptr[r], indptr[r+1])} val[e] * X[col[e], c] for the rows of
// at most thr entries, with X (n, k) and Y (m, k) row-major and contiguous;
// longer rows are left to the colsort2 tail (colsort2_spmm.cu).
//
// Replaces the JAX package's routed Pallas kernel at its SpMM site,
// _routed_kernel (kernels/pallas_routed.py:426, launched at K > 0 from
// :709).  It is the SpMV's design (routed_spmv.cu) with a (window, tile)
// block of X in shared memory: the grid's second axis runs over tiles of
// at most 32 columns, a thread owns one row and keeps the tile's sums in
// registers, and the block stages X[w Ws, (w+1) Ws) x the tile for each
// window the plan lists for its row block.  So that a window and a 32-column
// tile fit the 227 KB a block may hold, the SpMM windows are Ws = W / 16
// rows for f32 and W / 32 for f64 (at most 128 KB), and the plan lists them
// separately, by the same rule: a window is staged where the row block has
// at least Ws / 8 entries in it.  Entries of the other windows read their
// row of X directly (through L2), in the same in-order pass over the row.
//
// Each (row, column) of Y is written once: no atomics, the same result on
// every run.  Bound by bytes: per entry a value and a column index per
// column tile, the staged windows of X once per row block and the directly
// gathered rows of X (through L2), Y written once.  Row and element offsets
// of X and Y are 64-bit.
#include "common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxSmem = 128 * 1024;
constexpr int kTile = 32;

template <typename Store, typename Acc>
__global__ void routed_spmm_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y, int m, int n, int k,
                                   int thr, const int* __restrict__ win_ptr,
                                   const int* __restrict__ win_ids, int Ws) {
  extern __shared__ unsigned char smem_raw[];
  Acc* xs = reinterpret_cast<Acc*>(smem_raw);
  const int rb = blockIdx.x;
  const int cb = static_cast<int>(blockIdx.y) * kTile;
  const int tc = min(kTile, k - cb);
  const long long r = static_cast<long long>(rb) * blockDim.x + threadIdx.x;
  int p = 0, stop = 0;
  bool own = false;
  if (r < m) {
    p = indptr[r];
    stop = indptr[r + 1];
    own = stop - p <= thr;
  }
  if (!own) stop = p;
  Acc acc[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) acc[c] = 0;

  for (int wi = win_ptr[rb]; wi < win_ptr[rb + 1]; ++wi) {
    const int c0 = win_ids[wi] * Ws;
    const int width = min(Ws, n - c0);
    for (; p < stop && col[p] < c0; ++p) {
      const Acc v = to_acc<Acc>(val[p]);
      const Acc* xr = x + static_cast<long long>(col[p]) * k + cb;
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (c < tc) acc[c] += v * xr[c];
    }
    __syncthreads();                  // the previous window is consumed
    for (int i = threadIdx.x; i < width * tc; i += blockDim.x) {
      const int rr = i / tc;
      xs[i] = x[static_cast<long long>(c0 + rr) * k + cb + (i - rr * tc)];
    }
    __syncthreads();
    for (; p < stop && col[p] < c0 + width; ++p) {
      const Acc v = to_acc<Acc>(val[p]);
      const Acc* xr = xs + (col[p] - c0) * tc;
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (c < tc) acc[c] += v * xr[c];
    }
  }
  for (; p < stop; ++p) {
    const Acc v = to_acc<Acc>(val[p]);
    const Acc* xr = x + static_cast<long long>(col[p]) * k + cb;
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (c < tc) acc[c] += v * xr[c];
  }
  if (own) {
    Acc* yr = y + r * k + cb;
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (c < tc) yr[c] = acc[c];
  }
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val, const void* x,
           void* y, int m, int n, int k, int thr, const void* win_ptr,
           const void* win_ids, int Ws, int block, void* stream) {
  const long long smem = static_cast<long long>(Ws) * kTile * sizeof(Acc);
  if (k < 1 || Ws < 1 || smem > kMaxSmem || block % 32 != 0 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;     // once per instantiation, before any capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_spmm_kernel<Store, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long blocks = (static_cast<long long>(m) + block - 1) / block;
  const long long ntiles = (k + kTile - 1) / kTile;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL || ntiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tc = k < kTile ? k : kTile;
  routed_spmm_kernel<Store, Acc>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(ntiles)), block,
         static_cast<size_t>(Ws) * tc * sizeof(Acc), static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(col),
          static_cast<const Store*>(val), static_cast<const Acc*>(x),
          static_cast<Acc*>(y), m, n, k, thr, static_cast<const int*>(win_ptr),
          static_cast<const int*>(win_ids), Ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_routed_spmm_f32(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int n, int k, int thr,
                         const void* win_ptr, const void* win_ids, int Ws,
                         int block, void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, n, k, thr, win_ptr,
                              win_ids, Ws, block, stream);
}

int cusp_routed_spmm_bf16(const void* indptr, const void* col, const void* val,
                          const void* x, void* y, int m, int n, int k, int thr,
                          const void* win_ptr, const void* win_ids, int Ws,
                          int block, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, n, k, thr,
                                      win_ptr, win_ids, Ws, block, stream);
}

int cusp_routed_spmm_f64(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int n, int k, int thr,
                         const void* win_ptr, const void* win_ids, int Ws,
                         int block, void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, n, k, thr, win_ptr,
                                win_ids, Ws, block, stream);
}

}  // extern "C"
