// Virtual-row CSR SpMV with a fixed-plane fold:
// y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]].
//
// Replaces the JAX package's colsort2 Pallas kernel at its SpMV site,
// _v2_kernel (kernels/pallas_colsort2.py:519, launched at K = 0 from :833).
// On the TPU every row is cut into K virtual rows that live in K identity
// planes, so that the fold back to y is a reshape and a sum with no scatter;
// the entries are packed into (sublane, lane) slots by an edge colouring so
// that the in-lane take can gather x, and the one-hot MXU dot scatters the
// products; rows above hub_cap move to a region of degree-sorted virtual
// rows of at most 128 entries, folded by a scatter-add.  Hopper gathers
// natively, so what carries over is the idea, not the slot layout:
//
//   * a row of at most thr = min(hub_cap, K * V) entries is cut into K
//     virtual rows of at most V entries, plane k holding entries
//     [k V, (k + 1) V) of the row.  A team of T lanes (the fewest, a power
//     of two up to 32, that leave each lane at most 4 entries) sums one
//     virtual row and meets in a shuffle reduction of width T.  The K teams
//     of a row sit side by side in one block and put their sums in shared
//     memory; the plane-0 lane folds them in plane order 0..K-1, the
//     counterpart of the JAX reshape(K, m).sum(0).  Every team gets at most
//     V entries: there are no length bins (the binned rail's) and no block
//     per long row;
//   * rows longer than thr are hub rows, cut on the host into virtual rows
//     of at most 128 entries sorted by degree (the JAX hub region).  A warp
//     sums each hub virtual row (colsort2_hub_kernel), and a second small
//     kernel folds each hub row's virtual rows in order into y.
//
// Each row of y is written exactly once, by its plane-0 lane or by the hub
// fold: no atomics, the same result on every run, and no zeroing of y.
// Bound by bytes: per entry a value and a column index, the gathered x
// (through L2), two indptr reads per row and y once; the hub tables are
// 16 bytes per 128 hub entries.
#include "common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr unsigned kFull = 0xffffffffu;

template <typename Store, typename Acc>
__global__ void colsort2_main_kernel(const int* __restrict__ indptr,
                                     const int* __restrict__ col,
                                     const Store* __restrict__ val,
                                     const Acc* __restrict__ x,
                                     Acc* __restrict__ y, int m, int K, int V,
                                     int T, int thr) {
  __shared__ Acc part[kMaxBlock];
  const int rows = static_cast<int>(blockDim.x) / (K * T);
  const int team = static_cast<int>(threadIdx.x) / T;
  const int lane = static_cast<int>(threadIdx.x) & (T - 1);
  const int plane = team % K;
  const int rl = team / K;
  const long long r = static_cast<long long>(blockIdx.x) * rows + rl;
  bool own = false;
  int start = 0, stop = 0;
  if (rl < rows && r < m) {
    start = indptr[r];
    stop = indptr[r + 1];
    own = stop - start <= thr;
  }
  Acc acc = 0;
  if (own) {
    const int lo = start + plane * V;
    const int hi = min(stop, lo + V);
    for (int e = lo + lane; e < hi; e += T)
      acc += to_acc<Acc>(val[e]) * x[col[e]];
  }
  // every lane of the warp reaches the shuffles; teams of T lanes lie
  // inside one warp, since T divides 32
  for (int off = T >> 1; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off, T);
  if (lane == 0) part[team] = acc;
  __syncthreads();
  if (own && plane == 0 && lane == 0) {
    Acc total = 0;
    for (int k = 0; k < K; ++k) total += part[rl * K + k];
    y[r] = total;
  }
}

// one warp per hub virtual row: part[v] = sum of entries [lo[v], hi[v])
template <typename Store, typename Acc>
__global__ void colsort2_hub_kernel(const int* __restrict__ col,
                                    const Store* __restrict__ val,
                                    const Acc* __restrict__ x,
                                    const int* __restrict__ lo,
                                    const int* __restrict__ hi, int nv,
                                    Acc* __restrict__ part) {
  const long long v =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  Acc acc = 0;
  if (v < nv)
    for (int e = lo[v] + lane; e < hi[v]; e += 32)
      acc += to_acc<Acc>(val[e]) * x[col[e]];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off);
  if (v < nv && lane == 0) part[v] = acc;
}

// one thread per hub row: its virtual rows [ptr[h], ptr[h+1]) in order
template <typename Acc>
__global__ void colsort2_hub_fold_kernel(const Acc* __restrict__ part,
                                         const int* __restrict__ rows,
                                         const int* __restrict__ ptr, int nh,
                                         Acc* __restrict__ y) {
  const long long h = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (h >= nh) return;
  Acc total = 0;
  for (int v = ptr[h]; v < ptr[h + 1]; ++v) total += part[v];
  y[rows[h]] = total;
}

bool bad_team(int K, int T, int block) {
  return K < 1 || T < 1 || T > 32 || (T & (T - 1)) != 0 || K * T > block ||
         block % 32 != 0 || block > kMaxBlock;
}

template <typename Store, typename Acc>
int launch_main(const void* indptr, const void* col, const void* val,
                const void* x, void* y, int m, int K, int V, int T, int thr,
                int block, void* stream) {
  if (bad_team(K, T, block) || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = block / (K * T);
  const long long blocks = (static_cast<long long>(m) + rows - 1) / rows;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  colsort2_main_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const Acc*>(x),
      static_cast<Acc*>(y), m, K, V, T, thr);
  return static_cast<int>(cudaGetLastError());
}

template <typename Store, typename Acc>
int launch_hub(const void* col, const void* val, const void* x, const void* lo,
               const void* hi, int nv, const void* rows, const void* ptr,
               int nh, void* part, void* y, int block, void* stream) {
  if (block % 32 != 0 || block > kMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (nv == 0 || nh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long warps_per_block = block / 32;
  colsort2_hub_kernel<Store, Acc>
      <<<static_cast<unsigned>((nv + warps_per_block - 1) / warps_per_block), block, 0, s>>>(
          static_cast<const int*>(col), static_cast<const Store*>(val),
          static_cast<const Acc*>(x), static_cast<const int*>(lo),
          static_cast<const int*>(hi), nv, static_cast<Acc*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsort2_hub_fold_kernel<Acc><<<static_cast<unsigned>((nh + block - 1) / block),
                                  block, 0, s>>>(
      static_cast<const Acc*>(part), static_cast<const int*>(rows),
      static_cast<const int*>(ptr), nh, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_colsort2_spmv_f32(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int K, int V, int T,
                           int thr, int block, void* stream) {
  return launch_main<float, float>(indptr, col, val, x, y, m, K, V, T, thr,
                                   block, stream);
}

int cusp_colsort2_spmv_bf16(const void* indptr, const void* col, const void* val,
                            const void* x, void* y, int m, int K, int V, int T,
                            int thr, int block, void* stream) {
  return launch_main<__nv_bfloat16, float>(indptr, col, val, x, y, m, K, V, T,
                                           thr, block, stream);
}

int cusp_colsort2_spmv_f64(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int K, int V, int T,
                           int thr, int block, void* stream) {
  return launch_main<double, double>(indptr, col, val, x, y, m, K, V, T, thr,
                                     block, stream);
}

int cusp_colsort2_hub_f32(const void* col, const void* val, const void* x,
                          const void* lo, const void* hi, int nv,
                          const void* rows, const void* ptr, int nh, void* part,
                          void* y, int block, void* stream) {
  return launch_hub<float, float>(col, val, x, lo, hi, nv, rows, ptr, nh, part,
                                  y, block, stream);
}

int cusp_colsort2_hub_bf16(const void* col, const void* val, const void* x,
                           const void* lo, const void* hi, int nv,
                           const void* rows, const void* ptr, int nh,
                           void* part, void* y, int block, void* stream) {
  return launch_hub<__nv_bfloat16, float>(col, val, x, lo, hi, nv, rows, ptr,
                                          nh, part, y, block, stream);
}

int cusp_colsort2_hub_f64(const void* col, const void* val, const void* x,
                          const void* lo, const void* hi, int nv,
                          const void* rows, const void* ptr, int nh, void* part,
                          void* y, int block, void* stream) {
  return launch_hub<double, double>(col, val, x, lo, hi, nv, rows, ptr, nh,
                                    part, y, block, stream);
}

}  // extern "C"
