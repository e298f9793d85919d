// Row-binned CSR SpMV: y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]].
//
// Replaces the JAX package's row-lane-binned Pallas kernels at their SpMV
// sites, _binned_kernel (kernels/pallas_binned.py:193) and _streamed_kernel
// (:274, K = 0).  Those cut the entries into (Bs, 128) slot blocks whose lane
// is the target row, so that the TPU scatters for free, and spill heavy rows
// to an XLA segment sum; the streamed one exists because x outgrew VMEM.
// Hopper gathers natively and reads x through L2, so one kernel serves both
// sites, and its design is the fork's CSR kernel family instead
// (csr_kernel.h:160-372: thread, warp and block per row): the host plan
// sorts the rows into bins, and each bin runs with its own group size.
//
//   * group G in {1, 2, 4, 8, 16, 32}: G consecutive lanes own one row,
//     stride over its entries and meet in a __shfl_down_sync reduction of
//     width G.  Every lane of a warp reaches the shuffles, so the full mask
//     is right even where the last rows of a bin leave lanes idle.
//   * group 0: one block owns one row (the hub rows, longer than hub_cap),
//     reduced through warp shuffles and one shared-memory pass.  This takes
//     the place of the JAX segment-sum spill.
//
// One launch covers every bin: a block finds its bin from the bins' first
// block indices.  Each row is written by exactly one group, so there are
// no atomics and the result is the same on every run.  Bound by bytes: per
// entry a value and a column index, plus the gathered x (through L2), two
// indptr reads and one perm read per row, and y once.
#include "common.cuh"

namespace {

constexpr int kMaxBins = 8;

struct Bins {
  int n;
  int first_block[kMaxBins + 1];   // bin b owns blocks [first_block[b], first_block[b+1])
  int row_start[kMaxBins];         // its rows are perm[row_start[b] : row_start[b] + count[b]]
  int count[kMaxBins];
  int group[kMaxBins];             // lanes per row; 0 = one block per row
};

template <typename Store, typename Acc>
__global__ void binned_spmv_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const int* __restrict__ perm, Bins bins,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y) {
  int b = 0;
  while (b + 1 < bins.n && static_cast<int>(blockIdx.x) >= bins.first_block[b + 1]) ++b;
  const int local_block = static_cast<int>(blockIdx.x) - bins.first_block[b];
  const int group = bins.group[b];

  if (group == 0) {
    __shared__ Acc warp_sums[32];
    const int r = perm[bins.row_start[b] + local_block];
    const int stop = indptr[r + 1];
    Acc acc = 0;
    for (int e = indptr[r] + threadIdx.x; e < stop; e += blockDim.x)
      acc += to_acc<Acc>(val[e]) * x[col[e]];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc total = 0;
      for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_sums[w];
      y[r] = total;
    }
    return;
  }

  const int local = local_block * (static_cast<int>(blockDim.x) / group) +
                    static_cast<int>(threadIdx.x) / group;
  const int lane = threadIdx.x & (group - 1);
  const bool live = local < bins.count[b];
  int r = 0;
  Acc acc = 0;
  if (live) {
    r = perm[bins.row_start[b] + local];
    const int stop = indptr[r + 1];
    for (int e = indptr[r] + lane; e < stop; e += group)
      acc += to_acc<Acc>(val[e]) * x[col[e]];
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  if (live && lane == 0) y[r] = acc;
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val,
           const void* perm, const void* bins_host, int nbins, const void* x,
           void* y, int block, void* stream) {
  if (nbins < 1 || nbins > kMaxBins || block % 32 != 0 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* desc = static_cast<const int*>(bins_host);   // (row_start, count, group) per bin
  Bins bins{};
  bins.n = nbins;
  long long blocks = 0;
  for (int b = 0; b < nbins; ++b) {
    bins.row_start[b] = desc[3 * b];
    bins.count[b] = desc[3 * b + 1];
    bins.group[b] = desc[3 * b + 2];
    const int g = bins.group[b];
    if (g < 0 || g > 32 || (g & (g - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    bins.first_block[b] = static_cast<int>(blocks);
    const int rows_per_block = g == 0 ? 1 : block / g;
    blocks += (bins.count[b] + rows_per_block - 1) / rows_per_block;
  }
  bins.first_block[nbins] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  binned_spmv_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const int*>(perm), bins,
      static_cast<const Acc*>(x), static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_binned_spmv_f32(const void* indptr, const void* col, const void* val,
                         const void* perm, const void* bins, int nbins,
                         const void* x, void* y, int block, void* stream) {
  return launch<float, float>(indptr, col, val, perm, bins, nbins, x, y, block,
                              stream);
}

int cusp_binned_spmv_bf16(const void* indptr, const void* col, const void* val,
                          const void* perm, const void* bins, int nbins,
                          const void* x, void* y, int block, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, perm, bins, nbins, x,
                                      y, block, stream);
}

int cusp_binned_spmv_f64(const void* indptr, const void* col, const void* val,
                         const void* perm, const void* bins, int nbins,
                         const void* x, void* y, int block, void* stream) {
  return launch<double, double>(indptr, col, val, perm, bins, nbins, x, y,
                                block, stream);
}

}  // extern "C"
