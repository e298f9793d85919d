// Virtual-row CSR SpMM with a fixed-plane fold: Y[r, c] =
// sum_{e in [indptr[r], indptr[r+1])} val[e] * X[col[e], c], with X (n, k)
// and Y (m, k) row-major and contiguous.
//
// Replaces the JAX package's colsort2 Pallas kernel at its SpMM site,
// _v2_kernel (kernels/pallas_colsort2.py:519, launched at K > 0 from :883,
// the k columns of a VMEM chunk looped inside the kernel).  It walks the
// SpMV's plan (colsort2_spmv.cu): a row of at most thr entries is K
// virtual rows of at most V entries, and rows above thr are hub rows cut
// into virtual rows of at most 128 entries.  Lanes run over a tile of X's
// columns, as in binned_spmm.cu: a team of `tile` lanes, tile the least
// power of two >= k capped at 32, spans the columns, and each lane walks the
// team's virtual row in entry order for its column, so an entry's value and
// column index are one broadcast load for the team and the lanes read
// `tile` consecutive values of a row of X.
//
//   * main: the K teams of a row sit side by side in one block; their sums
//     go to shared memory and the plane-0 team folds them column by column
//     in plane order, writing each (row, column) of Y once;
//   * hub: a team per (hub virtual row, column tile) writes the virtual
//     row's partial sums, and a fold kernel adds each hub row's virtual rows
//     in order, one thread per (hub row, column).
//
// No atomics: the same result on every run.  Bound by bytes: per entry a
// value and a column index per column tile, the gathered rows of X (through
// L2), Y written once.  Row and element offsets of X and Y are 64-bit.
#include "common.cuh"

namespace {

constexpr int kMaxBlock = 1024;

template <typename Store, typename Acc>
__global__ void colsort2_spmm_main_kernel(const int* __restrict__ indptr,
                                          const int* __restrict__ col,
                                          const Store* __restrict__ val,
                                          const Acc* __restrict__ x,
                                          Acc* __restrict__ y, int m, int k,
                                          int K, int V, int thr, int tile) {
  __shared__ Acc part[kMaxBlock];
  const int rows = static_cast<int>(blockDim.x) / (K * tile);
  const int team = static_cast<int>(threadIdx.x) / tile;
  const int lane = static_cast<int>(threadIdx.x) & (tile - 1);
  const int plane = team % K;
  const int rl = team / K;
  const long long r = static_cast<long long>(blockIdx.x) * rows + rl;
  const int c = static_cast<int>(blockIdx.y) * tile + lane;
  bool own = false;
  int start = 0, stop = 0;
  if (rl < rows && r < m) {
    start = indptr[r];
    stop = indptr[r + 1];
    own = stop - start <= thr;
  }
  Acc acc = 0;
  if (own && c < k) {
    const int lo = start + plane * V;
    const int hi = min(stop, lo + V);
    for (int e = lo; e < hi; ++e)
      acc += to_acc<Acc>(val[e]) * x[static_cast<long long>(col[e]) * k + c];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (own && plane == 0 && c < k) {
    Acc total = 0;
    for (int p = 0; p < K; ++p) total += part[(rl * K + p) * tile + lane];
    y[r * k + c] = total;
  }
}

// a team of `tile` lanes per (hub virtual row, column tile):
// part[v, c] = sum over entries [lo[v], hi[v]) of val * X[col, c]
template <typename Store, typename Acc>
__global__ void colsort2_spmm_hub_kernel(const int* __restrict__ col,
                                         const Store* __restrict__ val,
                                         const Acc* __restrict__ x,
                                         const int* __restrict__ lo,
                                         const int* __restrict__ hi, int nv,
                                         int k, int tile,
                                         Acc* __restrict__ part) {
  const long long v = static_cast<long long>(blockIdx.x) * (blockDim.x / tile) +
                      threadIdx.x / tile;
  const int c = static_cast<int>(blockIdx.y) * tile + (threadIdx.x & (tile - 1));
  if (v >= nv || c >= k) return;
  Acc acc = 0;
  for (int e = lo[v]; e < hi[v]; ++e)
    acc += to_acc<Acc>(val[e]) * x[static_cast<long long>(col[e]) * k + c];
  part[v * k + c] = acc;
}

// one thread per (hub row, column): its virtual rows in order
template <typename Acc>
__global__ void colsort2_spmm_hub_fold_kernel(const Acc* __restrict__ part,
                                              const int* __restrict__ rows,
                                              const int* __restrict__ ptr,
                                              int nh, int k,
                                              Acc* __restrict__ y) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(nh) * k) return;
  const long long h = i / k;
  const int c = static_cast<int>(i - h * k);
  Acc total = 0;
  for (int v = ptr[h]; v < ptr[h + 1]; ++v) total += part[static_cast<long long>(v) * k + c];
  y[static_cast<long long>(rows[h]) * k + c] = total;
}

int tile_of(int k) {
  int tile = 1;
  while (tile < k && tile < 32) tile <<= 1;
  return tile;
}

template <typename Store, typename Acc>
int launch_main(const void* indptr, const void* col, const void* val,
                const void* x, void* y, int m, int k, int K, int V, int thr,
                int block, void* stream) {
  if (k < 1 || K < 1 || V < 1 || block % 32 != 0 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = tile_of(k);
  if (K * tile > block) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = block / (K * tile);
  const long long blocks = (static_cast<long long>(m) + rows - 1) / rows;
  const long long ntiles = (k + tile - 1) / tile;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL || ntiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  colsort2_spmm_main_kernel<Store, Acc>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(ntiles)), block, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(col),
          static_cast<const Store*>(val), static_cast<const Acc*>(x),
          static_cast<Acc*>(y), m, k, K, V, thr, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename Store, typename Acc>
int launch_hub(const void* col, const void* val, const void* x, const void* lo,
               const void* hi, int nv, const void* rows, const void* ptr,
               int nh, void* part, void* y, int k, int block, void* stream) {
  if (k < 1 || block % 32 != 0 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nv == 0 || nh == 0) return 0;
  const int tile = tile_of(k);
  const long long teams = block / tile;
  const long long blocks = (nv + teams - 1) / teams;
  const long long ntiles = (k + tile - 1) / tile;
  const long long items = static_cast<long long>(nh) * k;
  if (ntiles > 65535 || (items + block - 1) / block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  colsort2_spmm_hub_kernel<Store, Acc>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(ntiles)), block, 0, s>>>(
          static_cast<const int*>(col), static_cast<const Store*>(val),
          static_cast<const Acc*>(x), static_cast<const int*>(lo),
          static_cast<const int*>(hi), nv, k, tile, static_cast<Acc*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsort2_spmm_hub_fold_kernel<Acc>
      <<<static_cast<unsigned>((items + block - 1) / block), block, 0, s>>>(
          static_cast<const Acc*>(part), static_cast<const int*>(rows),
          static_cast<const int*>(ptr), nh, k, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_colsort2_spmm_f32(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int k, int K, int V,
                           int thr, int block, void* stream) {
  return launch_main<float, float>(indptr, col, val, x, y, m, k, K, V, thr,
                                   block, stream);
}

int cusp_colsort2_spmm_bf16(const void* indptr, const void* col, const void* val,
                            const void* x, void* y, int m, int k, int K, int V,
                            int thr, int block, void* stream) {
  return launch_main<__nv_bfloat16, float>(indptr, col, val, x, y, m, k, K, V,
                                           thr, block, stream);
}

int cusp_colsort2_spmm_f64(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int k, int K, int V,
                           int thr, int block, void* stream) {
  return launch_main<double, double>(indptr, col, val, x, y, m, k, K, V, thr,
                                     block, stream);
}

int cusp_colsort2_hub_spmm_f32(const void* col, const void* val, const void* x,
                               const void* lo, const void* hi, int nv,
                               const void* rows, const void* ptr, int nh,
                               void* part, void* y, int k, int block,
                               void* stream) {
  return launch_hub<float, float>(col, val, x, lo, hi, nv, rows, ptr, nh, part,
                                  y, k, block, stream);
}

int cusp_colsort2_hub_spmm_bf16(const void* col, const void* val, const void* x,
                                const void* lo, const void* hi, int nv,
                                const void* rows, const void* ptr, int nh,
                                void* part, void* y, int k, int block,
                                void* stream) {
  return launch_hub<__nv_bfloat16, float>(col, val, x, lo, hi, nv, rows, ptr,
                                          nh, part, y, k, block, stream);
}

int cusp_colsort2_hub_spmm_f64(const void* col, const void* val, const void* x,
                               const void* lo, const void* hi, int nv,
                               const void* rows, const void* ptr, int nh,
                               void* part, void* y, int k, int block,
                               void* stream) {
  return launch_hub<double, double>(col, val, x, lo, hi, nv, rows, ptr, nh,
                                    part, y, k, block, stream);
}

}  // extern "C"
