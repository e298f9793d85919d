// The body of the DIA SpMM kernels: dia_spmm_kernel and its band twin
// dia_band_spmm_kernel (dia_spmm.cu), and the DIA SpMM probe's shipped,
// rows=R and nodata modes (dia_spmm_probe.cu), which must equal the shipped
// kernel bit for bit.
//
// A team of T lanes (T a power of two, at most 32) owns R consecutive rows
// of Y and a tile of T * C columns; lane l of the team keeps the C columns
// from c0 = (tile * T + l) * C of its R rows in registers, R * C
// accumulators.  X and Y are read and written W values at a time (16-byte
// loads and stores where W * sizeof(Acc) is 16, 8-byte where 8).  The
// wrapper (kernels/dia.py, spmm_schedule) picks W, C, R and T:
//
//   * k <= 4 (LOBPCG's k = 3): C = k, T = 1, so every lane works and a
//     lane owns whole rows; a warp's diagonal values are one load over 32 R
//     consecutive rows, not a broadcast to a team of 4 with one lane idle;
//   * k > 4: C = W = 16 / sizeof(Acc) where k % W == 0 and X and Y are
//     16-byte aligned, else the 8-byte width, else one value; T = the least
//     power of two >= k / C, capped at 32, and past 32 C columns the grid's
//     second dimension walks the column tiles.
//
// R rows a lane: the rows of X that diagonal d reads for the lane's rows,
// i0 + r + off_d for r < R, overlap those of the diagonal before by R - s
// rows when off_d - off_{d-1} = s < R (poisson's -1, 0, +1), so those stay
// in registers and only s rows are loaded.  Each element's sum runs
// diagonal by diagonal in offset order, acc = fma(a, x, acc) from 0, in the
// accumulation type (f32 for f32 and bf16 storage, f64 for f64): the
// plain version's order, and the same FMAs as the probe's team=T and xtile
// modes.  Bounds are tested here (0 <= i + off < n), so X needs no
// padding; the band twin reads a padded X_pad without that test.  Element
// offsets of X and Y are 64-bit: 1M rows x k = 128 f32 is 512 MB.
#pragma once

#include "common.cuh"

// Rows i0 .. i0 + R - 1 (those below `rows`), columns c0 .. c0 + C - 1 of
// Y[i, c] = sum_d data[d * pitch + i] * X[base + i + off_d, c].  Band:
// X is X_pad, every row read is inside it (the wrapper checks), and rows
// at or past `rows` read nothing; else base = 0 and a row of X outside
// [0, n) adds nothing.  NoData: coefficients 1 (the probe's nodata mode).
template <typename Store, typename Acc, int W, int C, int R, bool Band,
          bool NoData>
__device__ __forceinline__ void dia_spmm_rows(
    const Store* __restrict__ data, const int* __restrict__ offsets, int ndiag,
    long long pitch, const Acc* __restrict__ x, long long base, long long n,
    Acc* __restrict__ y, long long rows, int k, long long i0, int c0) {
  Acc acc[R][C], xr[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0;
  int prev = 0;
  for (int d = 0; d < ndiag; ++d) {
    const int off = __ldg(offsets + d);
    // rows r < keep of X hold the row this diagonal reads already
    int keep = 0;
    if (R > 1 && d > 0) {
      const int s_now = off - prev;
#pragma unroll
      for (int s = 1; s < R; ++s) {
        if (s_now == s) {
#pragma unroll
          for (int r = 0; r + s < R; ++r)
#pragma unroll
            for (int c = 0; c < C; ++c) xr[r][c] = xr[r + s][c];
          // the band twin loads no row past `rows`
          const long long have = Band ? rows - i0 - s : R - s;
          keep = have < 0 ? 0 : (have < R - s ? static_cast<int>(have) : R - s);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + r;
      const long long j = base + i + off;
      const bool load = Band ? i < rows : (j >= 0 && j < n);
      if (r >= keep && load) load_cols<Acc, W, C>(x + j * k + c0, xr[r]);
      if (i < rows && load) {
        const Acc a = NoData ? Acc(1) : to_acc<Acc>(data[d * pitch + i]);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fma_rn(a, xr[r][c], acc[r][c]);
      }
    }
    prev = off;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r < rows) store_cols<Acc, W, C>(y + (i0 + r) * k + c0, acc[r]);
}

// The (rows, column) block a thread owns: team threadIdx.x >> team_shift of
// its block, lane threadIdx.x & (T - 1); false where it owns nothing.
template <int C, int R>
__device__ __forceinline__ bool spmm_owner(long long rows, int k, int team_shift,
                                           long long* i0, int* c0) {
  const int lane = threadIdx.x & ((1 << team_shift) - 1);
  *i0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> team_shift) +
         (threadIdx.x >> team_shift)) * R;
  *c0 = ((static_cast<int>(blockIdx.y) << team_shift) + lane) * C;
  return *i0 < rows && *c0 < k;
}

// The grid for `rows` rows at R a team of T = 1 << team_shift lanes of C
// columns each, or false where it does not fit the launch limits.
inline bool spmm_grid(long long rows, int k, int cols, int R, int team_shift,
                      int block, dim3* grid) {
  if (k < 1 || block % 32 != 0 || block > 1024 || team_shift < 0 ||
      team_shift > 5 || cols < 1 || R < 1)
    return false;
  const long long rows_per_block = static_cast<long long>(block >> team_shift) * R;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const long long span = static_cast<long long>(cols) << team_shift;
  const long long tiles = (k + span - 1) / span;
  if (blocks > 0x7fffffffLL || tiles > 65535) return false;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  return true;
}
