// Row-binned CSR SpMV: y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]].
//
// Replaces the JAX package's row-lane-binned Pallas kernels at their SpMV
// sites, _binned_kernel (kernels/pallas_binned.py:193) and _streamed_kernel
// (:274, K = 0).  Those cut the entries into (Bs, 128) slot blocks whose lane
// is the target row, so that the TPU scatters for free, and spill heavy rows
// to an XLA segment sum; the streamed one exists because x outgrew VMEM.
// Hopper gathers natively and reads x through L2, so one kernel serves both
// sites.  The first kernel here was the fork's CSR kernel family
// (csr_kernel.h:160-372): rows permuted into bins of 1 to 32 lanes a row
// and a block a hub row, run bin by bin.  Each lane took its row's entries
// one at a time, its loads of col and val coalesced only where a bin's rows
// lay side by side, and the longest rows (the warp and block bins) started
// last; on a 1M-row matrix of Pareto row lengths it lost to cuSPARSE by
// 28 % (PERF.md).  Now the rows are binned by length into three classes,
// each walked in row order, as csrc/rail_rows.cuh walks the rails' rows:
//
//   * a row of at most 32 entries (and at most hub_cap): a lane.  A warp
//     takes 32 consecutive rows; its lanes load the rows' entries together,
//     coalesced, 128 at a time with four gathers of x in flight, and each
//     lane adds its own row's products in entry order;
//   * a row of 33 to hub_cap entries: a warp (the plan lists them), lane
//     l adding entries l, l + 32, ... with four loads in flight, then a
//     fixed shuffle tree;
//   * a row above hub_cap (a hub row, listed too): a block, thread t adding
//     entries t, t + B, ... with four loads in flight, fixed shuffle trees
//     and the warps' sums added in order.
//
// One launch: the hub rows' blocks first, then the long rows' warps, then
// the short rows' blocks, so that the longest sums start first.  Each row
// is written once, by its lane, warp or block, in an order fixed by the row
// and the block size: no atomics, the same result on every run.  Bound by
// bytes: per entry a value and a column index, the gathered x (through L2),
// two indptr reads per row and y once.  Shared memory: the warps' product
// slots (kAhead values a thread).
#include "rail_rows.cuh"

namespace {

constexpr int kMaxBlock = 1024;

// Hub row r by the whole block; warp_sums: 32 slots of shared memory.
template <typename Store, typename Acc>
__device__ __forceinline__ void hub_row(const int* __restrict__ indptr,
                                        const int* __restrict__ col,
                                        const Store* __restrict__ val,
                                        const Acc* __restrict__ x,
                                        Acc* __restrict__ y, int r,
                                        Acc* warp_sums) {
  const int s = indptr[r], L = indptr[r + 1] - s;
  Acc acc = 0;
#pragma unroll 4
  for (int p = threadIdx.x; p < L; p += blockDim.x)
    acc += rail::term<rail::kFullMode, Store, Acc>(col, val, x, s + p);
  acc = rail::warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_sums[w];
    y[r] = total;
  }
}

template <typename Store, typename Acc>
__global__ void binned_spmv_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y, int m, int thr,
                                   const int* __restrict__ long_rows, int n_long,
                                   const int* __restrict__ hub_rows, int n_hub,
                                   int long_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* const smem = reinterpret_cast<Acc*>(smem_raw);
  const int b = blockIdx.x;
  if (b < n_hub) {
    hub_row<Store, Acc>(indptr, col, val, x, y, hub_rows[b], smem);
  } else if (b < n_hub + long_blocks) {
    const long long w = static_cast<long long>(b - n_hub) * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
    if (w < n_long)
      rail::long_row<rail::kFullMode, Store, Acc>(indptr, col, val, x, y,
                                                  long_rows[w], rail::kNoPlanes);
  } else {
    const int warp0 = threadIdx.x & ~31;
    const long long r0 =
        static_cast<long long>(b - n_hub - long_blocks) * blockDim.x + warp0;
    if (r0 < m)
      rail::short_rows<rail::kFullMode, Store, Acc>(
          indptr, col, val, x, y, m, r0, thr < rail::kShort ? thr : rail::kShort,
          thr, rail::kNoPlanes, smem + rail::kAhead * warp0);
  }
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val, const void* x,
           void* y, int m, int thr, const void* long_rows, int n_long,
           const void* hub_rows, int n_hub, int block, void* stream) {
  if (block % 32 != 0 || block < 32 || block > kMaxBlock || thr < 1 || n_long < 0 ||
      n_hub < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int short_blocks = 0;
  const long long walk = rail::grid_blocks(m, n_long, block, &short_blocks);
  if (walk < 0 || walk + n_hub > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = walk + n_hub;
  if (blocks == 0) return 0;
  const size_t smem = sizeof(Acc) * rail::kAhead * static_cast<size_t>(block);
  binned_spmv_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const Acc*>(x),
      static_cast<Acc*>(y), m, thr, static_cast<const int*>(long_rows), n_long,
      static_cast<const int*>(hub_rows), n_hub, static_cast<int>(walk - short_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_binned_spmv_f32(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int thr,
                         const void* long_rows, int n_long, const void* hub_rows,
                         int n_hub, int block, void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, thr, long_rows, n_long,
                              hub_rows, n_hub, block, stream);
}

int cusp_binned_spmv_bf16(const void* indptr, const void* col, const void* val,
                          const void* x, void* y, int m, int thr,
                          const void* long_rows, int n_long, const void* hub_rows,
                          int n_hub, int block, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, thr, long_rows,
                                      n_long, hub_rows, n_hub, block, stream);
}

int cusp_binned_spmv_f64(const void* indptr, const void* col, const void* val,
                         const void* x, void* y, int m, int thr,
                         const void* long_rows, int n_long, const void* hub_rows,
                         int n_hub, int block, void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, thr, long_rows, n_long,
                                hub_rows, n_hub, block, stream);
}

}  // extern "C"
