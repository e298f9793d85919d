// CSR SpMV over nnz-balanced tiles (the fork's csr_kernel_balanced, with
// row starts planned ahead of time as in its cpu_compute_row_starts):
// y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]].
//
// Replaces the JAX package's Pallas one-hot kernel, _onehot_kernel
// (kernels/pallas_csr.py:171).  That kernel plans nnz-balanced blocks with
// row and column windows, gathers x and scatters y through one-hot matrix
// products, and carries y across sequential grid steps, all because the TPU
// has no vector gather or scatter.  Hopper gathers natively and runs blocks
// in no order; what carries over is the nnz balance, which the TPU kernel's
// docstring names as its own rebuild target.
//
// Bound by bytes: per entry a value and a column index, plus the gathered
// x (through L2), indptr and y once.  The first version gave each row a
// warp, so a 5-entry row left 27 of 32 lanes idle and the kernel ran at 10 %
// of that bound, held by issue and latency.  Here every lane works on
// entries, whatever the row lengths:
//
//   * the entries are cut into tiles of E = block * kPerThread; the plan
//     holds tile_row[t], the row that holds entry t * E (one searchsorted
//     over indptr, at build time);
//   * a block loads its tile's col and val with 16-byte loads, gathers x
//     through the read-only path and writes the products to shared memory;
//   * it then reduces the rows tile_row[t] .. tile_row[t + 1] from shared
//     memory, their indptr loaded ahead of the tile: a lane a row for rows
//     of at most kWarpRow of the tile's entries, a warp a row above that
//     (the CSR-stream / CSR-vector split within a tile).  Every row that
//     lies whole in the tile is written directly, an empty row as 0;
//   * a tile whose rows outnumber its entries (a run of empty rows) is
//     walked by several blocks, each over at most E of its rows: block t
//     takes tile t's first E rows, and the plan lists the blocks after the
//     tiles' (split_tile, split_row: the tile and the first row of each),
//     so no block walks a long run of empty rows alone;
//   * a short row (at most kWarpRow entries) that a tile boundary cuts is
//     finished by the tile where it starts, which also computes the
//     kWarpRow products past its end, so every short row is summed in
//     entry order wherever the tiles fall;
//   * a longer row cut by a tile boundary leaves its partial in a carry
//     slot: slot 2t for the row cut at the tile's start, 2t + 1 for a row
//     that starts in the tile and runs past its end.  A second small kernel
//     folds them in tile order: every row's first carry is an odd slot, and
//     the row's later partials sit in the even slots of the tiles that
//     follow.
//
// No atomics: the result is the same on every run.  Where the columns are
// scattered (the skewed 1M-row matrix, LP) the kernel is held by x's
// gathers, a 32-byte sector of L2 for each 4-byte value, as cuSPARSE is.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRow = 32;   // a row with more of the tile's entries takes a warp
// entries a thread loads, one 16-byte load of col: tiles of 1024 entries at
// a block of 256, faster on an H100 than 8 or 16 a thread (PERF.md, row 4)
constexpr int kPerThread = 4;

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// A block a tile of blockDim.x * kPerThread entries and at most as many of
// its rows: block t < ntiles the first rows of tile t, a later block the
// rows that split_tile and split_row name.
template <typename Store, typename Acc>
__global__ void csr_tile_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ col,
                                const Store* __restrict__ val,
                                const Acc* __restrict__ x, Acc* __restrict__ y,
                                const int* __restrict__ tile_row,
                                const int* __restrict__ split_tile,
                                const int* __restrict__ split_row,
                                int* __restrict__ carry_row,
                                Acc* __restrict__ carry_val, int m,
                                long long nnz, int ntiles, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const bool first = static_cast<int>(blockIdx.x) < ntiles;
  const int tile = first ? blockIdx.x : split_tile[blockIdx.x - ntiles];
  const long long E = static_cast<long long>(kPerThread) * blockDim.x;
  Acc* prod = reinterpret_cast<Acc*>(smem);
  const long long t0 = tile * E, t1 = t0 + E;
  const long long left = nnz - t0;
  const int count = static_cast<int>(left < E ? (left > 0 ? left : 0) : E);

  const int r_lo = tile == 0 ? 0 : tile_row[tile];
  const int r_next = tile_row[tile + 1];
  // this block's rows w_lo .. w_hi of the tile's r_lo .. min(r_next, m - 1)
  const int w_lo = first ? r_lo : split_row[blockIdx.x - ntiles];
  const long long w_end = static_cast<long long>(w_lo) + E - 1;
  const int r_hi = r_next < m - 1 ? r_next : m - 1;
  const int w_hi = w_end < r_hi ? static_cast<int>(w_end) : r_hi;
  // the first row of this thread's first pass, loaded ahead of the tile
  long long a0 = 0, b0 = 0;
  if (w_lo + tid <= w_hi) {
    a0 = indptr[w_lo + tid];
    b0 = indptr[w_lo + tid + 1];
  }

  // 1. the tile's products into shared memory
  if (vec && count == E) {
    const long long e = t0 + kPerThread * tid;
    const int4 c = __ldg(reinterpret_cast<const int4*>(col + e));
    Acc v[4];
    load4<Store, Acc>(val + e, v);
    Acc p[4] = {v[0] * __ldg(x + c.x), v[1] * __ldg(x + c.y),
                v[2] * __ldg(x + c.z), v[3] * __ldg(x + c.w)};
    store4(prod + kPerThread * tid, p);
  } else {
    for (int k = tid; k < count; k += blockDim.x)
      prod[k] = to_acc<Acc>(val[t0 + k]) * __ldg(x + col[t0 + k]);
  }
  // and up to kWarpRow products past the tile's end, for a short row that
  // starts in the tile and runs on
  if (tid < kWarpRow && t1 + tid < nnz)
    prod[E + tid] = to_acc<Acc>(val[t1 + tid]) * __ldg(x + col[t1 + tid]);

  // the carry slots' rows, long rows only: slot 2t the row cut at the
  // tile's start, slot 2t + 1 a row that starts in the tile and runs past
  // its end; set by the tile's first block
  if (tid == 0 && first) {
    const long long lo_a = indptr[r_lo], lo_b = indptr[r_lo + 1];
    carry_row[2 * tile] =
        (tile > 0 && lo_a < t0 && lo_b - lo_a > kWarpRow) ? r_lo : -1;
    long long start = 0, stop = 0;
    if (r_next < m) {
      start = indptr[r_next];
      stop = indptr[r_next + 1];
    }
    carry_row[2 * tile + 1] = (t1 < nnz && start >= t0 && start < t1 &&
                               stop - start > kWarpRow) ? r_next : -1;
  }
  __syncthreads();

  // 2. the rows w_lo .. w_hi from shared memory; the loop is uniform
  // across each warp, so the full-mask shuffles see all 32 lanes.  A short
  // row (at most kWarpRow entries) belongs to the tile where it starts,
  // which adds up all its products in order, those past the tile's end
  // included, so that its sum does not depend on where the tiles cut (a
  // band of the mesh path gives the unsharded sums bit for bit).  A longer
  // row is summed by segments, a carry for each cut one.
  for (int base = w_lo + (tid & ~31); base <= w_hi; base += blockDim.x) {
    const int r = base + lane;
    int s = 0, e = 0;
    int slot = -1;                  // -1: y[r] is written here; else a carry slot
    bool own = false;               // this tile writes y[r] or r's carry
    if (r <= w_hi) {
      const long long a = base == w_lo + (tid & ~31) ? a0 : indptr[r];
      const long long b = base == w_lo + (tid & ~31) ? b0 : indptr[r + 1];
      if (b - a <= kWarpRow) {
        own = a >= t0 && (a < t1 || a == b);
        if (own) {
          s = static_cast<int>(a - t0);
          e = static_cast<int>(b - t0);
        }
      } else {
        s = static_cast<int>((a > t0 ? a : t0) - t0);
        e = static_cast<int>((b < t1 ? b : t1) - t0);
        own = e > s;
        if (a < t0 || b > t1) slot = 2 * tile + (a < t0 ? 0 : 1);
      }
    }
    const bool wide = e - s > kWarpRow;
    Acc acc = 0;
    if (!wide) {
      for (int k = s; k < e; ++k) acc += prod[k];
    }
    unsigned todo = __ballot_sync(kFull, wide);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int ws = __shfl_sync(kFull, s, src), we = __shfl_sync(kFull, e, src);
      Acc part = 0;
      for (int k = ws + lane; k < we; k += 32) part += prod[k];
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_down_sync(kFull, part, off);
      part = __shfl_sync(kFull, part, 0);
      if (lane == src) acc = part;
    }
    if (own) {
      if (slot < 0)
        y[r] = acc;                 // empty rows included
      else
        carry_val[slot] = acc;
    }
  }
}

// Each row's first carry (an odd slot) adds the row's partials from the even
// slots of the tiles that follow, in order.
template <typename Acc>
__global__ void csr_fold_kernel(const int* __restrict__ carry_row,
                                const Acc* __restrict__ carry_val,
                                long long ntiles, Acc* __restrict__ y) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < ntiles; t += stride) {
    const int r = carry_row[2 * t + 1];
    if (r < 0) continue;
    Acc sum = carry_val[2 * t + 1];
    for (long long u = t + 1; u < ntiles && carry_row[2 * u] == r; ++u)
      sum += carry_val[2 * u];
    y[r] = sum;
  }
}

template <typename Store, typename Acc>
int launch(const void* indptr, const void* col, const void* val, const void* x,
           void* y, int m, long long nnz, const void* tile_row,
           const void* split_tile, const void* split_row, int nsplit,
           void* carry_row, void* carry_val, int block, void* stream) {
  if (block % 32 != 0 || block < 32 || block > 1024 || m < 1 || nnz < 0 ||
      nsplit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long E = static_cast<long long>(kPerThread) * block;
  const long long ntiles = nnz ? (nnz + E - 1) / E : 1;
  if (ntiles + nsplit > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads of col and val where both are aligned to four entries
  const bool vec = reinterpret_cast<uintptr_t>(col) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % (4 * sizeof(Store)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(Acc) * (kPerThread * static_cast<size_t>(block) + kWarpRow);
  csr_tile_kernel<Store, Acc>
      <<<static_cast<unsigned>(ntiles + nsplit), block, smem, s>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(col),
          static_cast<const Store*>(val), static_cast<const Acc*>(x),
          static_cast<Acc*>(y), static_cast<const int*>(tile_row),
          static_cast<const int*>(split_tile), static_cast<const int*>(split_row),
          static_cast<int*>(carry_row), static_cast<Acc*>(carry_val), m, nnz,
          static_cast<int>(ntiles), vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntiles < 2) return static_cast<int>(err);
  csr_fold_kernel<Acc><<<grid_for(ntiles, 256), 256, 0, s>>>(
      static_cast<const int*>(carry_row), static_cast<const Acc*>(carry_val),
      ntiles, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_csr_spmv_f32(const void* indptr, const void* col, const void* val,
                      const void* x, void* y, int m, long long nnz,
                      const void* tile_row, const void* split_tile,
                      const void* split_row, int nsplit, void* carry_row,
                      void* carry_val, int block, void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, nnz, tile_row,
                              split_tile, split_row, nsplit, carry_row,
                              carry_val, block, stream);
}

int cusp_csr_spmv_bf16(const void* indptr, const void* col, const void* val,
                       const void* x, void* y, int m, long long nnz,
                       const void* tile_row, const void* split_tile,
                       const void* split_row, int nsplit, void* carry_row,
                       void* carry_val, int block, void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, nnz, tile_row,
                                      split_tile, split_row, nsplit,
                                      carry_row, carry_val, block, stream);
}

int cusp_csr_spmv_f64(const void* indptr, const void* col, const void* val,
                      const void* x, void* y, int m, long long nnz,
                      const void* tile_row, const void* split_tile,
                      const void* split_row, int nsplit, void* carry_row,
                      void* carry_val, int block, void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, nnz, tile_row,
                                split_tile, split_row, nsplit, carry_row,
                                carry_val, block, stream);
}

}  // extern "C"
