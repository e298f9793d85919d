// DIA SpMM: Y[i, c] = sum_d data[d * pitch + i] * X[i + offsets[d], c], with X
// (n, k) and Y (m, k) row-major and contiguous.
//
// Replaces the JAX package's Pallas DIA SpMM kernel, _dia_spmm_kernel
// (kernels/pallas_dia.py:381, launched from _dia_spmm :342).  The JAX
// package sends k <= 64 to an XLA path (_dia_spmm_xla :271) because Mosaic
// lowers blocks under 128 lanes badly; here one kernel serves every k.
//
// Bound by bytes: ndiag * rows * sizeof(store) of diagonal data, X read once
// (n * k * 4 in f32) and Y written once (m * k * 4).  The first kernel took
// a team of min(32, next_pow2(k)) lanes a row with one 4-byte load of X per
// lane and diagonal, and was bound by its load instructions (the probe's
// 16-byte team=128 mode ran 2.5x faster at k = 128).  So a lane now takes
// C columns of R consecutive rows with 16-byte loads and stores, a whole
// row where k <= 4, and keeps the rows of X that neighbouring diagonals
// share in registers: see dia_spmm_body.cuh.
#include "dia_spmm_body.cuh"

// The shipped rows a lane, R, where k <= 4 and past it: ROWS_NARROW and
// ROWS_WIDE in kernels/dia.py.
constexpr int kRowsNarrow = 2;
constexpr int kRowsWide = 4;

// f(R) as an integral constant for the shipped R `rows`; else
// cudaErrorInvalidValue.
template <typename F>
int with_rows(int rows, F&& f) {
  if (rows == kRowsNarrow) return f(std::integral_constant<int, kRowsNarrow>{});
  if (rows == kRowsWide) return f(std::integral_constant<int, kRowsWide>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Store, typename Acc, int W, int C, int R>
__global__ void dia_spmm_kernel(const Store* __restrict__ data,
                                const int* __restrict__ offsets, int ndiag,
                                long long pitch, const Acc* __restrict__ x,
                                Acc* __restrict__ y, int m, int n, int k,
                                int team_shift) {
  long long i0;
  int c0;
  if (!spmm_owner<C, R>(m, k, team_shift, &i0, &c0)) return;
  dia_spmm_rows<Store, Acc, W, C, R, false, false>(data, offsets, ndiag, pitch,
                                                   x, 0, n, y, m, k, i0, c0);
}

// One row band of a DIA matrix times a dense block, the block apply of the
// banded via_dia plan (the JAX package runs the vector kernel of
// parallel/sharded_plans.py:154 under a vmap over the columns):
// Y[i, c] = sum_d data[d * pitch + i] * X_pad[left + row0 + i + offsets[d], c]
// for the band's rows i < band, X_pad the replicated X (n, k) padded with
// `left` zero rows in front and enough behind, so there is no bounds test
// (the wrapper checks X_pad's rows against the offsets).  The body, teams
// and summation order of dia_spmm_kernel: a band's rows equal the whole
// matrix's.
template <typename Store, typename Acc, int W, int C, int R>
__global__ void dia_band_spmm_kernel(const Store* __restrict__ data,
                                     const int* __restrict__ offsets, int ndiag,
                                     long long pitch,
                                     const Acc* __restrict__ x_pad,
                                     long long base, Acc* __restrict__ y,
                                     int band, int k, int team_shift) {
  long long i0;
  int c0;
  if (!spmm_owner<C, R>(band, k, team_shift, &i0, &c0)) return;
  dia_spmm_rows<Store, Acc, W, C, R, true, false>(data, offsets, ndiag, pitch,
                                                  x_pad, base, 0, y, band, k,
                                                  i0, c0);
}

namespace {

template <typename Store, typename Acc>
int launch(const void* data, const void* offsets, int ndiag, long long pitch,
           const void* x, void* y, int m, int n, int k, int width, int cols,
           int rows, int team_shift, int block, void* stream) {
  dim3 grid;
  if (!spmm_grid(m, k, cols, rows, team_shift, block, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_rows(rows, [&](auto r) {
    return with_width<Acc>(width, cols, [&](auto w, auto c) {
      dia_spmm_kernel<Store, Acc, decltype(w)::value, decltype(c)::value,
                      decltype(r)::value>
          <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const Store*>(data), static_cast<const int*>(offsets),
              ndiag, pitch, static_cast<const Acc*>(x), static_cast<Acc*>(y), m,
              n, k, team_shift);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

template <typename Store, typename Acc>
int launch_band(const void* data, const void* offsets, int ndiag,
                long long pitch, const void* x_pad, long long left,
                long long row0, void* y, int band, int k, int width, int cols,
                int rows, int team_shift, int block, void* stream) {
  dim3 grid;
  if (!spmm_grid(band, k, cols, rows, team_shift, block, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_rows(rows, [&](auto r) {
    return with_width<Acc>(width, cols, [&](auto w, auto c) {
      dia_band_spmm_kernel<Store, Acc, decltype(w)::value, decltype(c)::value,
                           decltype(r)::value>
          <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const Store*>(data), static_cast<const int*>(offsets),
              ndiag, pitch, static_cast<const Acc*>(x_pad), left + row0,
              static_cast<Acc*>(y), band, k, team_shift);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace

extern "C" {

int cusp_dia_spmm_f32(const void* data, const void* offsets, int ndiag,
                      long long pitch, const void* x, void* y, int m, int n,
                      int k, int width, int cols, int rows, int team_shift,
                      int block, void* stream) {
  return launch<float, float>(data, offsets, ndiag, pitch, x, y, m, n, k, width,
                            cols, rows, team_shift, block, stream);
}

int cusp_dia_band_spmm_f32(const void* data, const void* offsets, int ndiag,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int k, int width,
                           int cols, int rows, int team_shift, int block,
                           void* stream) {
  return launch_band<float, float>(data, offsets, ndiag, pitch, x_pad, left, row0,
                                 y, band, k, width, cols, rows, team_shift,
                                 block, stream);
}

int cusp_dia_spmm_bf16(const void* data, const void* offsets, int ndiag,
                      long long pitch, const void* x, void* y, int m, int n,
                      int k, int width, int cols, int rows, int team_shift,
                      int block, void* stream) {
  return launch<__nv_bfloat16, float>(data, offsets, ndiag, pitch, x, y, m, n, k, width,
                            cols, rows, team_shift, block, stream);
}

int cusp_dia_band_spmm_bf16(const void* data, const void* offsets, int ndiag,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int k, int width,
                           int cols, int rows, int team_shift, int block,
                           void* stream) {
  return launch_band<__nv_bfloat16, float>(data, offsets, ndiag, pitch, x_pad, left, row0,
                                 y, band, k, width, cols, rows, team_shift,
                                 block, stream);
}

int cusp_dia_spmm_f64(const void* data, const void* offsets, int ndiag,
                      long long pitch, const void* x, void* y, int m, int n,
                      int k, int width, int cols, int rows, int team_shift,
                      int block, void* stream) {
  return launch<double, double>(data, offsets, ndiag, pitch, x, y, m, n, k, width,
                            cols, rows, team_shift, block, stream);
}

int cusp_dia_band_spmm_f64(const void* data, const void* offsets, int ndiag,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int k, int width,
                           int cols, int rows, int team_shift, int block,
                           void* stream) {
  return launch_band<double, double>(data, offsets, ndiag, pitch, x_pad, left, row0,
                                 y, band, k, width, cols, rows, team_shift,
                                 block, stream);
}

}  // extern "C"
