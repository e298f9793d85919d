// The row walk that the colsort2 and routed SpMV kernels share
// (colsort2_spmv.cu, routed_spmv.cu) and that the routed probe takes apart
// (routed_probe.cu): y[r] = sum of val[e] * x[col[e]] over
// row r's entries, for the rows of at most thr entries.
//
// Every lane works on entries, whatever the rows' lengths, and every row's
// sum is taken in an order fixed by the row alone (its entries, the plane
// length V), never by where a block, a warp group or a band of a mesh
// falls:
//
//   * a short row, of at most kShort (32) entries, is summed by one lane.
//     A warp takes 32 consecutive rows; its lanes load the short rows'
//     entries together, 128 at a time and in entry order (four coalesced
//     loads of col and val and four gathers of x a lane, all in flight at
//     once), park the products in 128 slots of shared memory, and each lane
//     adds its own row's products from there, one after the other.  Where
//     the warp's rows hold no long or hub row, their entries are contiguous
//     and a lane's entry is the warp's first plus its index; otherwise a
//     five-step search over the rows' prefix sums (in registers, by
//     shuffles) finds it;
//   * a long row, of kShort < L <= thr entries, takes a warp of its own
//     (the plan lists them): lane l adds the row's entries l, l + 32, ...
//     in order (a plain loop unrolled by four where the row is one plane,
//     four chunks of 32 loaded ahead where planes close inside it), and a
//     shuffle tree of 32 folds the lanes;
//   * colsort2's planes: a row's entries [k V, (k + 1) V) form plane k.
//     The lane or the warp closes a plane's sum where the plane ends and
//     adds the plane sums in order 0, 1, ..., the counterpart of the JAX
//     reshape(K, m).sum(0).  routed passes V = kNoPlanes: one plane.
//
// Every x is read through L1/L2 (__ldg); no block meets at a barrier.
//
// Rows above thr (hub rows) are written by the colsort2 hub pair; each
// other row of y is written here exactly once, by its lane or its warp's
// lane 0: no atomics, the same bits on every call.
#pragma once

#include <climits>

#include "common.cuh"

namespace rail {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kShort = 32;                // a row of at most 32 entries: one lane
constexpr int kNoPlanes = INT_MAX;        // routed: a row is one plane
constexpr int kAhead = 4;                 // chunks of 32 a warp loads ahead
constexpr int kSlots = 32 * kAhead;       // a warp's product slots in shared memory

// What the walk does: the shipped kernels use kFullMode; the routed probe
// takes each in turn.
enum Mode {
  kFullMode = 0,    // the shipped walk
  kNoHub = 1,       // as kFullMode; the hub rows of y written 0 here
  kLoads = 2,       // val + 1e-30 col summed, x not read; hub rows 0
};

// One entry's term.
template <int M, typename Store, typename Acc>
__device__ __forceinline__ Acc term(const int* __restrict__ col,
                                    const Store* __restrict__ val,
                                    const Acc* __restrict__ x, int e) {
  const int c = col[e];
  if (M == kLoads) return to_acc<Acc>(val[e]) + Acc(1e-30) * static_cast<Acc>(c);
  return to_acc<Acc>(val[e]) * __ldg(x + c);
}

// Lane 0 gets the sum of the warp's 32 values, by a fixed tree.
template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// The short rows among the warp's rows r0 .. r0 + 31 (r0 < m); buf is the
// warp's kSlots slots of shared memory.  lim = min(kShort, thr).
template <int M, typename Store, typename Acc>
__device__ __forceinline__ void short_rows(
    const int* __restrict__ indptr, const int* __restrict__ col,
    const Store* __restrict__ val, const Acc* __restrict__ x,
    Acc* __restrict__ y, int m, long long r0, int lim, int thr, int V,
    Acc* buf) {
  const int lane = threadIdx.x & 31;
  const long long r = r0 + lane;
  int s = 0, L = 0;
  if (r < m) {
    s = indptr[r];
    L = indptr[r + 1] - s;
  }
  const bool mine = r < m && L <= lim;
  const int Ls = mine ? L : 0;
  int incl = Ls;                          // inclusive prefix sum of Ls
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int start = incl - Ls;            // this row's first product
  const bool gapless = __ballot_sync(kFull, r < m && !mine && L > 0) == 0;
  const int base = __shfl_sync(kFull, s, 0);
  Acc sum = 0, plane = 0;
  int pos = 0;                            // the row's entries in the open plane
  for (int c = 0; c < total; c += kSlots) {   // uniform across the warp
    Acc p[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = c + 32 * u + lane;
      int e = base + i;
      if (!gapless) {                     // the last row whose start <= i
        int j = 0;
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(kFull, start, j + step) <= i) j += step;
        e = __shfl_sync(kFull, s, j) + (i - __shfl_sync(kFull, start, j));
      }
      p[u] = i < total ? term<M, Store, Acc>(col, val, x, e)
                       : Acc(0);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) buf[32 * u + lane] = p[u];
    __syncwarp();
    const int a = max(start, c), b = min(start + Ls, c + kSlots);
    for (int k = a; k < b; ++k) {
      plane += buf[k - c];
      if (++pos == V) {
        sum += plane;
        plane = 0;
        pos = 0;
      }
    }
    __syncwarp();
  }
  if (mine) {
    y[r] = sum + plane;
  } else if ((M == kNoHub || M == kLoads) && r < m && L > thr) {
    y[r] = 0;
  }
}

// A long row r, by the whole warp, in planes of V entries.
template <int M, typename Store, typename Acc>
__device__ __forceinline__ void long_row(const int* __restrict__ indptr,
                                         const int* __restrict__ col,
                                         const Store* __restrict__ val,
                                         const Acc* __restrict__ x,
                                         Acc* __restrict__ y, int r, int V) {
  const int lane = threadIdx.x & 31;
  const int s = indptr[r], L = indptr[r + 1] - s;
  Acc total = 0, acc = 0;
  if (V >= L) {                           // one plane: the same sums, a plain loop
#pragma unroll 4
    for (int p = lane; p < L; p += 32)
      acc += term<M, Store, Acc>(col, val, x, s + p);
    total = warp_sum(acc);
    if (lane == 0) y[r] = total;
    return;
  }
  int k_end = V;                          // where the open plane ends
  for (int c0 = 0; c0 < L; c0 += 32 * kAhead) {
    Acc v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int p = c0 + 32 * u + lane;
      v[u] = p < L ? term<M, Store, Acc>(col, val, x, s + p)
                   : Acc(0);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + 32 * u;
      if (c >= L) break;
      const int p = c + lane;
      while (k_end < min(c + 32, L)) {    // a plane closes in this chunk
        if (p < k_end) {
          acc += v[u];
          v[u] = 0;
        }
        total += warp_sum(acc);
        acc = 0;
        k_end += V;
      }
      acc += v[u];
    }
  }
  total += warp_sum(acc);
  if (lane == 0) y[r] = total;
}

// The whole kernel body: blocks [0, short_blocks) walk the rows, a warp
// each 32 rows, block b rows [b B, (b + 1) B); later blocks give each
// listed long row a warp.  smem: kAhead * B product slots.
template <int M, typename Store, typename Acc>
__device__ __forceinline__ void rows_body(
    const int* __restrict__ indptr, const int* __restrict__ col,
    const Store* __restrict__ val, const Acc* __restrict__ x,
    Acc* __restrict__ y, int m, int thr, int V,
    const int* __restrict__ long_rows, int n_long, int short_blocks,
    Acc* smem) {
  const int warp0 = threadIdx.x & ~31;
  if (static_cast<int>(blockIdx.x) < short_blocks) {
    const long long r0 = static_cast<long long>(blockIdx.x) * blockDim.x + warp0;
    const int lim = thr < kShort ? thr : kShort;
    if (r0 < m)
      short_rows<M, Store, Acc>(indptr, col, val, x, y, m, r0, lim, thr, V,
                                smem + kAhead * warp0);
  } else {
    const long long w =
        static_cast<long long>(blockIdx.x - short_blocks) * (blockDim.x >> 5) +
        (threadIdx.x >> 5);
    if (w < n_long) long_row<M, Store, Acc>(indptr, col, val, x, y, long_rows[w], V);
  }
}

// Blocks of a launch: the short blocks, then the long rows' (block / 32 a
// block); 0 where the grid would not fit.
inline long long grid_blocks(int m, int n_long, int block, int* short_blocks) {
  const long long sb = (static_cast<long long>(m) + block - 1) / block;
  const long long lb = (static_cast<long long>(n_long) + (block >> 5) - 1) / (block >> 5);
  if (sb + lb > 0x7fffffffLL) return -1;
  *short_blocks = static_cast<int>(sb);
  return sb + lb;
}

}  // namespace rail
