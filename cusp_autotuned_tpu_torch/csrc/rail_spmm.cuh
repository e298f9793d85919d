// The CSR SpMM row walk that the colsort2, routed and binned SpMM kernels
// share (colsort2_spmm.cu, routed_spmm.cu, binned_spmm.cu): Y[r, c] = sum
// of val[e] * X[col[e], c] over row r's entries, for the rows of at most
// thr entries, with X (n, k) and Y (m, k) row-major and contiguous.
//
// The columns follow the DIA SpMM's schedule (kernels/dia.py
// spmm_schedule): a lane takes C columns with W-value loads and stores (16
// bytes where k and the alignment allow), all k columns where k <= 4, a team
// of T lanes a tile of T C columns, the grid's second dimension the tiles
// past it.  A warp's G = 32 / T teams take G consecutive slots, a team a
// slot: slot s walks row s, or with kPerm row perm[s] (the binned SpMM's
// rows in bin order), whose entries are [bounds[s].x, bounds[s].y): the
// plan's copy of indptr at perm[s], so that no load waits on another
// before the entries'.
//
// The warp loads its main rows' entries together, coalesced, 128 at a time
// into shared memory: by one offset where the packed entries are the
// stored ones from there (without kPerm: no hub row with entries lies among
// the warp's rows; with kPerm: every team with entries starts at the same
// offset from its packed start, as rows that follow each other in storage
// do), else by a search over the teams' starts.  Each team walks
// its row's entries from there in order, four rows of X in flight.  A
// row's sum is taken one plane at a time (plane q: its entries [q V, (q +
// 1) V)), each plane added to the row's total as it closes: colsort2's
// planes folded in order; routed passes V = kNoPlanes, one plane.  So a
// row's sum is serial in entry order from zero whatever k, C, W or T: the
// same bits on every load path and every call.  (Handing each team its own
// 4 T slots a round, so that a warp's teams all work each round, was 3-6 %
// slower on poisson5pt 1000x1000 and a 1M-row matrix of Pareto row lengths;
// PERF.md, row 7.)
//
// Every x is read through L1/L2 (__ldg); no block meets at a barrier.  Rows
// above thr (hub rows, with entries) are left to the colsort2 hub pair;
// each other row of Y is written here once, by its team.  Row and element
// offsets of X and Y are 64-bit.
#pragma once

#include <climits>

#include "common.cuh"

namespace rail_spmm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 128;               // entries a warp loads a round
constexpr int kNoPlanes = INT_MAX;        // V of a walk whose rows are one plane

// Shared memory of a block of `block` threads: each warp's kSlots column
// indices and values.
template <typename Acc>
inline size_t smem_bytes(int block) {
  return static_cast<size_t>(block >> 5) * kSlots * (sizeof(int) + sizeof(Acc));
}

// The grid of a walk over `rows` rows at k columns, or false where the
// launch does not fit (team_shift 0..5, block a multiple of 32 up to 1024).
inline bool grid_of(long long rows, int k, int cols, int team_shift, int block,
                    dim3* grid) {
  if (k < 1 || cols < 1 || team_shift < 0 || team_shift > 5 || block % 32 != 0 ||
      block < 32 || block > 1024)
    return false;
  const long long span = static_cast<long long>(cols) << team_shift;
  const long long tiles = (k + span - 1) / span;
  const long long per_block = static_cast<long long>(block >> 5) << (5 - team_shift);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (tiles > 65535 || blocks > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  return true;
}

// The walk over slots s < m (kPerm: m slots of perm and bounds, each row's
// Y row its own, indptr not read; else rows r < m, perm and bounds not
// read).
template <typename Store, typename Acc, int W, int C, bool kPerm>
__device__ __forceinline__ void walk(const int* __restrict__ indptr,
                                     const int* __restrict__ col,
                                     const Store* __restrict__ val,
                                     const int* __restrict__ perm,
                                     const int2* __restrict__ bounds,
                                     const Acc* __restrict__ x,
                                     Acc* __restrict__ y, int m, int k, int V,
                                     int thr, int team_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* const s_col = reinterpret_cast<int*>(smem) + warp * kSlots;
  Acc* const s_val = reinterpret_cast<Acc*>(
                         smem + (blockDim.x >> 5) * kSlots * sizeof(int)) +
                     warp * kSlots;
  const int T = 1 << team_shift;
  const int team = lane >> team_shift, tl = lane & (T - 1);
  const int G = 32 >> team_shift;
  const long long slot =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * G + team;
  const int c0 = ((static_cast<int>(blockIdx.y) << team_shift) + tl) * C;
  const bool mine = c0 < k;
  int start = 0, len = 0;
  bool main_row = false;
  long long r = slot;
  if (slot < m) {
    if constexpr (kPerm) {
      r = __ldg(perm + slot);
      const int2 b = __ldg(bounds + slot);
      start = b.x;
      len = b.y - b.x;
    } else {
      start = __ldg(indptr + r);
      len = __ldg(indptr + r + 1) - start;
    }
    main_row = len <= thr;
  }
  // the main rows' entries, packed: team t's at [first, first + ls) of the
  // warp's exclusive scan
  const int ls = main_row ? len : 0;
  int incl = ls;
  for (int off = 1; off < G; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off << team_shift);
    if (team >= off) incl += o;
  }
  const int first = incl - ls;
  const int total = __shfl_sync(kFull, incl, 31);
  // gapless: packed entry i is stored entry s0 + i
  bool gapless;
  int s0;
  if constexpr (kPerm) {
    // every team with entries at one offset from its packed start (a team
    // without entries holds no packed entry)
    const int d = start - first;
    s0 = __reduce_min_sync(kFull, ls > 0 ? d : INT_MAX);
    gapless = __all_sync(kFull, ls == 0 || d == s0);
  } else {
    // no hub row with entries among the warp's rows: the first row's start
    gapless = !__any_sync(kFull, slot < m && !main_row && len > 0);
    s0 = __shfl_sync(kFull, start, 0);
  }

  Acc acc[C], sum[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = sum[c] = 0;
  int left = V;                       // entries the open plane still takes
  for (int base = 0; base < total; base += kSlots) {
#pragma unroll
    for (int q = 0; q < kSlots / 32; ++q) {
      const int i = base + q * 32 + lane;
      // the team that holds packed entry i: the last whose first is <= i
      int t = 0;
      if (!gapless)
        for (int step = G >> 1; step > 0; step >>= 1) {
          const int f = __shfl_sync(kFull, first, (t + step) << team_shift);
          if (f <= i) t += step;
        }
      const int ft = __shfl_sync(kFull, first, t << team_shift);
      const int st = __shfl_sync(kFull, start, t << team_shift);
      if (i < total) {
        const long long e = gapless ? static_cast<long long>(s0) + i
                                    : static_cast<long long>(st) + (i - ft);
        s_col[q * 32 + lane] = __ldg(col + e);
        s_val[q * 32 + lane] = to_acc<Acc>(val[e]);
      }
    }
    __syncwarp();
    const int lo = max(first, base), hi = min(first + ls, base + kSlots);
    for (int i = lo; i < hi; i += 4) {   // four rows of X in flight
      const int n4 = min(4, hi - i);
      Acc a4[4], xv[4][C];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < n4) {
          a4[q] = s_val[i + q - base];
          if (mine)
            load_cols<Acc, W, C>(
                x + static_cast<long long>(s_col[i + q - base]) * k + c0, xv[q]);
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= n4) break;
        if (mine) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = fma_rn(a4[q], xv[q][c], acc[c]);
        }
        if (--left == 0) {            // the plane closes: fold it in order
#pragma unroll
          for (int c = 0; c < C; ++c) {
            sum[c] += acc[c];
            acc[c] = 0;
          }
          left = V;
        }
      }
    }
    __syncwarp();
  }
  if (main_row && mine) {
#pragma unroll
    for (int c = 0; c < C; ++c) sum[c] += acc[c];
    store_cols<Acc, W, C>(y + r * k + c0, sum);
  }
}

}  // namespace rail_spmm
