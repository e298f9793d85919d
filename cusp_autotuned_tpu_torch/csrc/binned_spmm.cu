// Row-binned CSR SpMM: Y[r, c] = sum_{e in [indptr[r], indptr[r+1])}
// val[e] * X[col[e], c], with X (n, k) and Y (m, k) row-major and contiguous.
//
// Replaces the JAX package's row-lane-binned Pallas SpMM kernel,
// _binned_spmm_kernel (kernels/pallas_binned.py:229, launched from :624),
// and the K > 0 use of the streamed site (:422, _streamed_kernel :274).
// Those read each (Bs, 128) entry block once and loop over the k columns
// held in VMEM.  Here the design is the reference's CSR x array2d block
// kernel (cusp/system/cuda/detail/multiply/csr_block_spmv.h:187-226): a
// team of T lanes, T the least power of two >= k capped at 32, spans a tile
// of T columns; the team walks one row's entries in order, so each entry's
// value and column index are read once per tile (one broadcast load for the
// team) and the lanes read T consecutive values of a row of X.  A k above
// 32 takes several tiles.  It walks the SpMV plan (perm, bins), so rows come
// in the plan's bin order and the rows of a warp have like lengths:
//
//   * a bin of group G >= 1 (the SpMV's lanes per row): 32 / T rows per
//     warp, one team each, per tile;
//   * group 0 (rows longer than hub_cap): a block per (row, tile), whose
//     teams split the row's entries round robin and add their sums column
//     by column in shared memory, in team order.
//
// Each (row, column) of Y is written by exactly one team: no atomics, the
// same result on every run.  Bound by bytes: per entry a value and a column
// index per tile, the gathered rows of X (through L2), and Y written once.
// A small k leaves lanes idle: k = 3 runs teams of 4 with one lane idle.
// Row and element offsets of X and Y are 64-bit: 1M rows x k = 128 passes
// 2^27 elements, and n * k can pass 2^31.
#include "common.cuh"

namespace {

constexpr int kMaxBins = 8;
constexpr int kMaxBlock = 1024;

struct Bins {
  int n;
  int first_block[kMaxBins + 1];   // bin b owns blocks [first_block[b], first_block[b+1])
  int row_start[kMaxBins];         // its rows are perm[row_start[b] : row_start[b] + count[b]]
  int count[kMaxBins];
  int group[kMaxBins];             // > 0: a team per row; 0: a block per row
};

template <typename Store, typename Acc>
__global__ void binned_spmm_kernel(const int* __restrict__ indptr,
                                   const int* __restrict__ col,
                                   const Store* __restrict__ val,
                                   const int* __restrict__ perm, Bins bins,
                                   const Acc* __restrict__ x,
                                   Acc* __restrict__ y, int k, int tile,
                                   int ntiles) {
  int b = 0;
  while (b + 1 < bins.n && static_cast<int>(blockIdx.x) >= bins.first_block[b + 1]) ++b;
  const int local_block = static_cast<int>(blockIdx.x) - bins.first_block[b];
  const int teams = static_cast<int>(blockDim.x) / tile;
  const int team = static_cast<int>(threadIdx.x) / tile;
  const int lane = static_cast<int>(threadIdx.x) & (tile - 1);

  if (bins.group[b] == 0) {
    __shared__ Acc part[kMaxBlock];
    const int r = perm[bins.row_start[b] + local_block / ntiles];
    const int c = (local_block % ntiles) * tile + lane;
    const bool live = c < k;
    const int stop = indptr[r + 1];
    Acc acc = 0;
    if (live)
      for (int e = indptr[r] + team; e < stop; e += teams)
        acc += to_acc<Acc>(val[e]) * x[static_cast<long long>(col[e]) * k + c];
    part[threadIdx.x] = acc;
    __syncthreads();
    if (team == 0 && live) {
      Acc total = 0;
      for (int t = 0; t < teams; ++t) total += part[t * tile + lane];
      y[static_cast<long long>(r) * k + c] = total;
    }
    return;
  }

  const long long item = static_cast<long long>(local_block) * teams + team;
  const long long local = item / ntiles;
  const int c = static_cast<int>(item - local * ntiles) * tile + lane;
  if (local >= bins.count[b] || c >= k) return;
  const int r = perm[bins.row_start[b] + local];
  const int stop = indptr[r + 1];
  Acc acc = 0;
#pragma unroll 4
  for (int e = indptr[r]; e < stop; ++e)
    acc += to_acc<Acc>(val[e]) * x[static_cast<long long>(col[e]) * k + c];
  y[static_cast<long long>(r) * k + c] = acc;
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val,
           const void* perm, const void* bins_host, int nbins, const void* x,
           void* y, int k, int block, void* stream) {
  if (nbins < 1 || nbins > kMaxBins || k < 1 || block % 32 != 0 ||
      block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile = 1;
  while (tile < k && tile < 32) tile <<= 1;
  const int ntiles = (k + tile - 1) / tile;
  const int teams = block / tile;
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
    const long long items = static_cast<long long>(bins.count[b]) * ntiles;
    blocks += g == 0 ? items : (items + teams - 1) / teams;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  bins.first_block[nbins] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  binned_spmm_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const int*>(perm), bins,
      static_cast<const Acc*>(x), static_cast<Acc*>(y), k, tile, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_binned_spmm_f32(const void* indptr, const void* col, const void* val,
                         const void* perm, const void* bins, int nbins,
                         const void* x, void* y, int k, int block,
                         void* stream) {
  return launch<float, float>(indptr, col, val, perm, bins, nbins, x, y, k,
                              block, stream);
}

int cusp_binned_spmm_bf16(const void* indptr, const void* col, const void* val,
                          const void* perm, const void* bins, int nbins,
                          const void* x, void* y, int k, int block,
                          void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, perm, bins, nbins, x,
                                      y, k, block, stream);
}

int cusp_binned_spmm_f64(const void* indptr, const void* col, const void* val,
                         const void* perm, const void* bins, int nbins,
                         const void* x, void* y, int k, int block,
                         void* stream) {
  return launch<double, double>(indptr, col, val, perm, bins, nbins, x, y, k,
                                block, stream);
}

}  // extern "C"
