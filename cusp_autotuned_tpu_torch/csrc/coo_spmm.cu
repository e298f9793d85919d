// nnz-balanced COO SpMM over a row-sorted entry stream:
// Y[row[e], c] += val[e] * X[col[e], c] for e < nnz, with X (n, k) and Y
// (m, k) row-major and contiguous, every row of Y written.
//
// Replaces the JAX package's column-lane-binned Pallas SpMM kernels: the
// main and hub SpMM passes (kernels/pallas_colsort.py:426 and :500, bodies
// _main_spmm_kernel :885 and _hub_spmm_kernel :932) and their streamed
// sites (:751, :831).  On the TPU those loop over the k columns of a VMEM
// block for each column-sorted entry block, with heavy rows in a second
// pass.  Here the entries keep the SpMV kernel's nnz-balanced chunks
// (coo_spmv.cu: 32 * vpt entries, one a warp), and the warp's lanes split
// into G = 32 / T teams of T lanes, each lane taking C columns of X and Y
// with 16-byte loads and stores where k and the alignment allow (the
// wrapper's schedule, kernels/dia.py spmm_schedule; at k <= 4 a lane takes
// all k columns, so T = 1 and every lane works):
//
//   * team t walks the t-th of the chunk's G segments of vpt * T entries,
//     in rounds of 4 T: lane l of the team loads entries 4 l .. 4 l + 3 of
//     the round (16-byte loads of row, col and val where vpt % 4 == 0), so
//     the warp loads its entry stream once and coalesced, and the team
//     walks them in order from its lanes' registers by shuffles; the first
//     kernel had every team load every entry, once per column tile;
//   * a row that starts and ends inside a segment is written directly, C
//     columns a lane; the segment's first and last rows go to a segmented
//     scan over the teams (the SpMV's scan over lanes, a team at a time);
//   * the chunk's first row leaves as a carry in slot 2w, a last row that
//     runs on into the next chunk in slot 2w + 1 (-1 where there is none),
//     a partial per slot and column; a second small kernel folds the
//     carries into Y in chunk order, a thread per (slot, column) indexed by
//     shifts, with no division;
//   * every row of Y is written: a team writes the empty rows between two
//     of its keys as 0, the first chunk those before row[0], the last team
//     those after the last key, a run of at most kGapRows rows; where a
//     longer run exists the plan zero-fills Y before the launch
//     (kernels/colsort.py, GAP_ROWS), so Y needs no fill otherwise.
//
// Past 32 C columns the grid's second dimension walks the column tiles,
// each warp of a tile loading the chunk's entries again.  A long row is
// just a long run of chunks, so this one kernel covers the main and the
// hub passes.  No atomics: a row's sum runs in an order fixed by the plan
// and k, the same on every run.  Bound by bytes: per entry a row index, a
// column index and a value, the gathered rows of X (through L2), Y once and
// the carries (8 + 2 k sizeof(acc) bytes a chunk).  Element offsets of X,
// Y and the carries are 64-bit.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kGapRows = 32;    // GAP_ROWS in kernels/colsort.py

// The C columns from c0 of the empty rows [from, to), where they are at
// most kGapRows; a longer run was zeroed before the launch.
template <typename Acc, int W, int C>
__device__ __forceinline__ void zero_rows(Acc* y, int k, int c0, int from,
                                          int to) {
  if (to - from > kGapRows) return;
  Acc zero[C];
#pragma unroll
  for (int c = 0; c < C; ++c) zero[c] = 0;
  for (int z = from; z < to; ++z)
    store_cols<Acc, W, C>(y + static_cast<long long>(z) * k + c0, zero);
}

template <typename Store, typename Acc, int W, int C>
__global__ void coo_spmm_chunk_kernel(const int* __restrict__ row,
                                      const int* __restrict__ col,
                                      const Store* __restrict__ val,
                                      long long nnz, int vpt, long long nchunks,
                                      bool vec, const Acc* __restrict__ x,
                                      Acc* __restrict__ y, int m, int k,
                                      int team_shift, int* __restrict__ carry_row,
                                      Acc* __restrict__ carry_val) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (w >= nchunks) return;           // uniform across the warp
  const int T = 1 << team_shift;
  const int team = lane >> team_shift, tl = lane & (T - 1);
  const int G = 32 >> team_shift;
  const int c0 = ((static_cast<int>(blockIdx.y) << team_shift) + tl) * C;
  const bool mine = c0 < k;           // lanes past k only pass entries on
  const bool marks = blockIdx.y == 0 && tl == 0;   // writes the row slots
  const long long begin = w * 32LL * vpt, end = begin + 32LL * vpt;
  const long long seg = begin + static_cast<long long>(team) * vpt * T;
  const long long seg_end = seg + static_cast<long long>(vpt) * T < nnz
                                ? seg + static_cast<long long>(vpt) * T
                                : nnz;

  // the team's walk: rows that start and end inside the segment are
  // written here; the first row's partial (head) and the last row's (acc)
  // go to the scan
  int first = -1, cur = -1;
  Acc acc[C], head[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = head[c] = 0;
  bool closed = false;                // the first row ended inside the segment
  for (int b = 0; b < vpt; b += 4) {
    const long long e0 = seg + static_cast<long long>(b) * T + 4 * tl;
    const long long rest = seg_end - e0;
    int rr[4], cc[4];
    Acc vv[4];
    if (vec && rest >= 4) {
      const int4 r4 = __ldg(reinterpret_cast<const int4*>(row + e0));
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(col + e0));
      rr[0] = r4.x; rr[1] = r4.y; rr[2] = r4.z; rr[3] = r4.w;
      cc[0] = c4.x; cc[1] = c4.y; cc[2] = c4.z; cc[3] = c4.w;
      load4<Store, Acc>(val + e0, vv);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = q < rest;
        rr[q] = in ? __ldg(row + e0 + q) : -1;
        cc[q] = in ? __ldg(col + e0 + q) : 0;
        vv[q] = in ? to_acc<Acc>(val[e0 + q]) : Acc(0);
      }
    }
    // the round's 4 T entries in order: 4 from each lane of the team
    for (int j = 0; j < T; ++j) {
      int er[4], ec[4];
      Acc ev[4], xv[4][C];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        er[q] = __shfl_sync(kFull, rr[q], j, T);
        ec[q] = __shfl_sync(kFull, cc[q], j, T);
        ev[q] = __shfl_sync(kFull, vv[q], j, T);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (mine && er[q] >= 0)
          load_cols<Acc, W, C>(x + static_cast<long long>(ec[q]) * k + c0, xv[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = er[q];
        if (r < 0) break;             // past the segment: no later entry either
        if (r != cur) {
          if (cur < 0) {
            first = r;
          } else {
            if (!closed) {
#pragma unroll
              for (int c = 0; c < C; ++c) head[c] = acc[c];
              closed = true;
            } else if (mine) {
              store_cols<Acc, W, C>(y + static_cast<long long>(cur) * k + c0, acc);
            }
            if (mine) zero_rows<Acc, W, C>(y, k, c0, cur + 1, r);
          }
          cur = r;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = 0;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fma_rn(ev[q], xv[q][c], acc[c]);
      }
    }
  }

  // segmented inclusive scan of the last rows' partials over the teams:
  // rows are sorted, so equal keys are adjacent (an empty team's key is -1)
  Acc v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = acc[c];
  for (int off = 1; off < G; off <<= 1) {
    const int ko = __shfl_up_sync(kFull, cur, off << team_shift);
    Acc vo[C];
#pragma unroll
    for (int c = 0; c < C; ++c) vo[c] = __shfl_up_sync(kFull, v[c], off << team_shift);
    if (team >= off && ko == cur) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] += vo[c];
    }
  }
  Acc v_prev[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v_prev[c] = __shfl_up_sync(kFull, v[c], T);
  const int k_prev = __shfl_up_sync(kFull, cur, T);
  const int next_first = __shfl_down_sync(kFull, first, T);
  const int chunk_first = __shfl_sync(kFull, first, 0);
  if (first < 0) return;              // a team past the last entry

  Acc* const slot0 = carry_val + 2 * w * k + c0;
  if (w == 0 && team == 0 && mine) zero_rows<Acc, W, C>(y, k, c0, 0, first);
  if (closed) {
    // the first row ends inside the segment: add what the teams before hold
    Acc total[C];
    const bool add = team > 0 && k_prev == first;
#pragma unroll
    for (int c = 0; c < C; ++c) total[c] = add ? head[c] + v_prev[c] : head[c];
    if (first == chunk_first) {
      if (marks) carry_row[2 * w] = first;
      if (mine) store_cols<Acc, W, C>(slot0, total);
    } else if (mine) {
      store_cols<Acc, W, C>(y + static_cast<long long>(first) * k + c0, total);
    }
  }
  // the last team with entries: team G - 1, or the one before an empty team
  const bool last_team = team == G - 1 || next_first < 0;
  if (!last_team) {
    if (next_first != cur) {          // the last row ends with the segment
      if (cur == chunk_first) {
        if (marks) carry_row[2 * w] = cur;
        if (mine) store_cols<Acc, W, C>(slot0, v);
      } else if (mine) {
        store_cols<Acc, W, C>(y + static_cast<long long>(cur) * k + c0, v);
      }
      if (mine) zero_rows<Acc, W, C>(y, k, c0, cur + 1, next_first);
    }
    return;
  }
  const int after = end < nnz ? __ldg(row + end) : m;   // the next chunk's first row
  if (cur == chunk_first) {
    if (marks) {
      carry_row[2 * w] = cur;
      carry_row[2 * w + 1] = -1;
    }
    if (mine) store_cols<Acc, W, C>(slot0, v);
  } else if (after == cur) {          // runs on into the next chunk
    if (marks) carry_row[2 * w + 1] = cur;
    if (mine) store_cols<Acc, W, C>(slot0 + k, v);
  } else {
    if (marks) carry_row[2 * w + 1] = -1;
    if (mine) store_cols<Acc, W, C>(y + static_cast<long long>(cur) * k + c0, v);
  }
  if (after != cur && mine) zero_rows<Acc, W, C>(y, k, c0, cur + 1, after);
}

// A thread per (carry slot, column): slot blockIdx.x * (block >> col_shift)
// + threadIdx.x >> col_shift, column blockIdx.y << col_shift | the rest.
template <typename Acc>
__global__ void coo_spmm_fold_kernel(const int* __restrict__ carry_row,
                                     const Acc* __restrict__ carry_val,
                                     long long ncarry, int k, int col_shift,
                                     Acc* __restrict__ y) {
  const long long i = static_cast<long long>(blockIdx.x) * (blockDim.x >> col_shift) +
                      (threadIdx.x >> col_shift);
  const int c = (static_cast<int>(blockIdx.y) << col_shift) +
                (threadIdx.x & ((1 << col_shift) - 1));
  if (i >= ncarry || c >= k) return;
  const int r = carry_row[i];
  if (r < 0) return;
  // the first slot of every chunk is set, so the previous set slot is at
  // i - 1 or i - 2
  int prev = -1;
  if (i >= 1) prev = carry_row[i - 1];
  if (prev < 0 && i >= 2) prev = carry_row[i - 2];
  if (prev == r) return;              // not the row's first carry
  Acc sum = 0;
  for (long long j = i; j < ncarry; ++j) {
    const int rj = carry_row[j];
    if (rj == r) sum += carry_val[j * k + c];
    else if (rj >= 0) break;
  }
  y[static_cast<long long>(r) * k + c] = sum;
}

template <typename Store, typename Acc>
int launch(const void* row, const void* col, const void* val, long long nnz,
           const void* x, void* y, int m, int k, void* carry_row,
           void* carry_val, int vpt, int width, int cols, int team_shift,
           int block, void* stream) {
  if (vpt < 1 || k < 1 || m < 1 || cols < 1 || team_shift < 0 ||
      team_shift > 5 || block % 32 != 0 || block < 32 || block > 1024 ||
      nnz <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nchunks = (nnz + 32LL * vpt - 1) / (32LL * vpt);
  const long long blocks = (32 * nchunks + block - 1) / block;
  const long long span = static_cast<long long>(cols) << team_shift;
  const long long tiles = (k + span - 1) / span;
  int col_shift = 0;
  while ((1 << col_shift) < k && col_shift < 5) ++col_shift;
  const long long fold_blocks =
      (2 * nchunks + (block >> col_shift) - 1) / (block >> col_shift);
  const long long fold_tiles = (k + (1 << col_shift) - 1) >> col_shift;
  if (blocks > 0x7fffffffLL || tiles > 65535 || fold_blocks > 0x7fffffffLL ||
      fold_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads of the entries where every lane's four start aligned
  const bool vec = vpt % 4 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(col) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % (4 * sizeof(Store)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_width<Acc>(width, cols, [&](auto w_, auto c_) {
    coo_spmm_chunk_kernel<Store, Acc, decltype(w_)::value, decltype(c_)::value>
        <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles)),
           block, 0, s>>>(
            static_cast<const int*>(row), static_cast<const int*>(col),
            static_cast<const Store*>(val), nnz, vpt, nchunks, vec,
            static_cast<const Acc*>(x), static_cast<Acc*>(y), m, k, team_shift,
            static_cast<int*>(carry_row), static_cast<Acc*>(carry_val));
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  coo_spmm_fold_kernel<Acc><<<dim3(static_cast<unsigned>(fold_blocks),
                                   static_cast<unsigned>(fold_tiles)),
                              block, 0, s>>>(
      static_cast<const int*>(carry_row), static_cast<const Acc*>(carry_val),
      2 * nchunks, k, col_shift, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_coo_spmm_f32(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, int m, int k,
                      void* carry_row, void* carry_val, int vpt, int width,
                      int cols, int team_shift, int block, void* stream) {
  return launch<float, float>(row, col, val, nnz, x, y, m, k, carry_row,
                            carry_val, vpt, width, cols, team_shift, block,
                            stream);
}

int cusp_coo_spmm_bf16(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, int m, int k,
                      void* carry_row, void* carry_val, int vpt, int width,
                      int cols, int team_shift, int block, void* stream) {
  return launch<__nv_bfloat16, float>(row, col, val, nnz, x, y, m, k, carry_row,
                            carry_val, vpt, width, cols, team_shift, block,
                            stream);
}

int cusp_coo_spmm_f64(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, int m, int k,
                      void* carry_row, void* carry_val, int vpt, int width,
                      int cols, int team_shift, int block, void* stream) {
  return launch<double, double>(row, col, val, nnz, x, y, m, k, carry_row,
                            carry_val, vpt, width, cols, team_shift, block,
                            stream);
}

}  // extern "C"
