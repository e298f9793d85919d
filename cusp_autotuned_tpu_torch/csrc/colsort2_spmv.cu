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
//   * a row of at most thr = min(hub_cap, K * V) entries is a main row,
//     cut into planes of V entries (plane k: entries [k V, (k + 1) V)),
//     each summed on its own and the plane sums added in order 0..K-1;
//   * the main rows are walked by rail_rows.cuh: a lane a row of at most
//     32 entries, the warp's lanes loading the rows' entries together, and
//     a warp for each longer main row (the plan lists them).  The first
//     version gave each row K teams of T lanes with T sized from V, so a
//     5-entry row of the plan K = 2, V = 8 left plane 1's team idle, and at
//     V = 32 eleven of sixteen lanes; each block also met at a barrier and
//     folded the planes through shared memory.  Now no lane waits on an
//     empty plane and no block meets at a barrier;
//   * rows longer than thr are hub rows, cut on the host into virtual rows
//     of at most 128 entries sorted by degree (the JAX hub region).  A warp
//     sums each hub virtual row (colsort2_hub_kernel), and a second small
//     kernel folds each hub row's virtual rows in order into y.
//
// Each row of y is written exactly once, by the main kernel or by the hub
// fold: no atomics, the same result on every run, and no zeroing of y.
// Bound by bytes: per entry a value and a column index, the gathered x
// (through L2), two indptr reads per row and y once; the hub tables are
// 16 bytes per 128 hub entries.
#include "rail_rows.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr unsigned kFull = 0xffffffffu;

// kOnePlane: no main row is longer than V, so no plane closes before the
// row's end and the walk is routed's, with the same sums; its instantiation
// drops the plane bookkeeping (LP's long rows ran 2-3 % faster so, PERF.md)
template <typename Store, typename Acc, bool kOnePlane>
__global__ void colsort2_main_kernel(const int* __restrict__ indptr,
                                     const int* __restrict__ col,
                                     const Store* __restrict__ val,
                                     const Acc* __restrict__ x,
                                     Acc* __restrict__ y, int m, int V, int thr,
                                     const int* __restrict__ long_rows,
                                     int n_long, int short_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rail::rows_body<rail::kFullMode, Store, Acc>(
      indptr, col, val, x, y, m, thr, kOnePlane ? rail::kNoPlanes : V, long_rows,
      n_long, short_blocks, reinterpret_cast<Acc*>(smem_raw));
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

template <typename Store, typename Acc>
int launch_main(const void* indptr, const void* col, const void* val,
                const void* x, void* y, int m, int V, int thr,
                const void* long_rows, int n_long, int block, void* stream) {
  if (block % 32 != 0 || block < 32 || block > kMaxBlock || V < 0 || thr < 1 ||
      n_long < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int short_blocks = 0;
  const long long blocks = rail::grid_blocks(m, n_long, block, &short_blocks);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const size_t smem = sizeof(Acc) * rail::kAhead * static_cast<size_t>(block);
  auto kernel = V == 0 ? colsort2_main_kernel<Store, Acc, true>   // one plane
                       : colsort2_main_kernel<Store, Acc, false>;
  kernel<<<static_cast<unsigned>(blocks), block, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const Acc*>(x),
      static_cast<Acc*>(y), m, V, thr, static_cast<const int*>(long_rows),
      n_long, short_blocks);
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
                           const void* x, void* y, int m, int V, int thr,
                           const void* long_rows, int n_long, int block,
                           void* stream) {
  return launch_main<float, float>(indptr, col, val, x, y, m, V, thr, long_rows,
                                   n_long, block, stream);
}

int cusp_colsort2_spmv_bf16(const void* indptr, const void* col, const void* val,
                            const void* x, void* y, int m, int V, int thr,
                            const void* long_rows, int n_long, int block,
                            void* stream) {
  return launch_main<__nv_bfloat16, float>(indptr, col, val, x, y, m, V, thr, long_rows,
                                           n_long, block, stream);
}

int cusp_colsort2_spmv_f64(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int V, int thr,
                           const void* long_rows, int n_long, int block,
                           void* stream) {
  return launch_main<double, double>(indptr, col, val, x, y, m, V, thr, long_rows,
                                     n_long, block, stream);
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
