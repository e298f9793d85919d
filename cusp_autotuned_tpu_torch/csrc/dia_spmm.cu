// DIA SpMM: Y[i, c] = sum_d data[d * pitch + i] * X[i + offsets[d], c], with X
// (n, k) and Y (m, k) row-major and contiguous.
//
// Replaces the JAX package's Pallas DIA SpMM kernel, _dia_spmm_kernel
// (kernels/pallas_dia.py:381, launched from _dia_spmm :342).  The JAX
// package sends k <= 64 to an XLA path (_dia_spmm_xla :271) because Mosaic
// lowers blocks under 128 lanes badly; here one kernel serves every k.
//
// Bound by bytes: ndiag * rows * sizeof(store) of diagonal data, X read once
// (n * k * 4 in f32) and Y written once (m * k * 4).  A team of T lanes, T
// the least power of two >= k capped at 32, spans a tile of T columns of one
// row of Y; a block holds block / T rows, and the grid's second dimension
// walks the column tiles.  So a warp reads a contiguous run of X (T values
// of 32 / T consecutive rows of X per diagonal), the diagonal value of a row
// is one broadcast load for its team, and the index math is shifts and
// masks, with no division per item.  A k that is no power of two leaves
// lanes of the last tile idle (k = 3: one of four).  The shifted rows of X are read again by the other diagonals
// through L1/L2.  Bounds are checked in the kernel (0 <= i + off < n), so X
// needs no padding.  Sums run in the accumulation type (f32 for f32 and
// bf16 storage, f64 for f64), diagonal by diagonal in offset order, as the
// plain version adds them.  Element offsets of X and Y are 64-bit: 1M rows
// x k = 128 f32 is 512 MB, and n * k can pass 2^31.
#include "common.cuh"

template <typename Store, typename Acc>
__global__ void dia_spmm_kernel(const Store* __restrict__ data,
                                const int* __restrict__ offsets, int ndiag,
                                long long pitch, const Acc* __restrict__ x,
                                Acc* __restrict__ y, int m, int n, int k,
                                int tile_shift) {
  const int tile = 1 << tile_shift;
  const long long i = static_cast<long long>(blockIdx.x) * (blockDim.x >> tile_shift) +
                      (threadIdx.x >> tile_shift);
  const int c = static_cast<int>(blockIdx.y) * tile + (threadIdx.x & (tile - 1));
  if (i >= m || c >= k) return;
  Acc acc = 0;
  for (int d = 0; d < ndiag; ++d) {
    const long long j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) acc += to_acc<Acc>(data[d * pitch + i]) * x[j * k + c];
  }
  y[i * k + c] = acc;
}

// One row band of a DIA matrix times a dense block, the block apply of the
// banded via_dia plan (the JAX package runs the vector kernel of
// parallel/sharded_plans.py:154 under a vmap over the columns):
// Y[i, c] = sum_d data[d * pitch + i] * X_pad[left + row0 + i + offsets[d], c]
// for the band's rows i < band, X_pad the replicated X (n, k) padded with
// `left` zero rows in front and enough behind, so there is no bounds test
// (the wrapper checks X_pad's rows against the offsets).  The teams, tiles
// and summation order of dia_spmm_kernel: one launch serves all k columns.
template <typename Store, typename Acc>
__global__ void dia_band_spmm_kernel(const Store* __restrict__ data,
                                     const int* __restrict__ offsets, int ndiag,
                                     long long pitch,
                                     const Acc* __restrict__ x_pad,
                                     long long base, Acc* __restrict__ y,
                                     int band, int k, int tile_shift) {
  const int tile = 1 << tile_shift;
  const long long i = static_cast<long long>(blockIdx.x) * (blockDim.x >> tile_shift) +
                      (threadIdx.x >> tile_shift);
  const int c = static_cast<int>(blockIdx.y) * tile + (threadIdx.x & (tile - 1));
  if (i >= band || c >= k) return;
  const long long xi = base + i;
  Acc acc = 0;
  for (int d = 0; d < ndiag; ++d)
    acc += to_acc<Acc>(data[d * pitch + i]) *
           x_pad[(xi + __ldg(offsets + d)) * k + c];
  y[i * k + c] = acc;
}

// The grid of the SpMM kernels: (blocks of block >> tile_shift rows, column
// tiles), or false where it does not fit the launch limits.
static bool spmm_grid(long long rows, int k, int block, int* tile_shift,
                      dim3* grid) {
  if (k < 1 || block % 32 != 0 || block > 1024) return false;
  int shift = 0;
  while ((1 << shift) < k && shift < 5) ++shift;
  const long long rows_per_block = block >> shift;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const long long tiles = (k + (1 << shift) - 1) >> shift;
  if (blocks > 0x7fffffffLL || tiles > 65535) return false;
  *tile_shift = shift;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  return true;
}

template <typename Store, typename Acc>
static int launch_band(const void* data, const void* offsets, int ndiag,
                       long long pitch, const void* x_pad, long long left,
                       long long row0, void* y, int band, int k, int block,
                       void* stream) {
  int tile_shift;
  dim3 grid;
  if (!spmm_grid(band, k, block, &tile_shift, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  dia_band_spmm_kernel<Store, Acc><<<grid, block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Store*>(data), static_cast<const int*>(offsets), ndiag,
      pitch, static_cast<const Acc*>(x_pad), left + row0, static_cast<Acc*>(y),
      band, k, tile_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename Store, typename Acc>
static int launch(const void* data, const void* offsets, int ndiag,
                  long long pitch, const void* x, void* y, int m, int n, int k,
                  int block, void* stream) {
  int tile_shift;
  dim3 grid;
  if (!spmm_grid(m, k, block, &tile_shift, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  dia_spmm_kernel<Store, Acc><<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Store*>(data), static_cast<const int*>(offsets), ndiag,
      pitch, static_cast<const Acc*>(x), static_cast<Acc*>(y), m, n, k,
      tile_shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int cusp_dia_spmm_f32(const void* data, const void* offsets, int ndiag,
                      long long pitch, const void* x, void* y, int m, int n,
                      int k, int block, void* stream) {
  return launch<float, float>(data, offsets, ndiag, pitch, x, y, m, n, k,
                              block, stream);
}

int cusp_dia_spmm_bf16(const void* data, const void* offsets, int ndiag,
                       long long pitch, const void* x, void* y, int m, int n,
                       int k, int block, void* stream) {
  return launch<__nv_bfloat16, float>(data, offsets, ndiag, pitch, x, y, m, n,
                                      k, block, stream);
}

int cusp_dia_spmm_f64(const void* data, const void* offsets, int ndiag,
                      long long pitch, const void* x, void* y, int m, int n,
                      int k, int block, void* stream) {
  return launch<double, double>(data, offsets, ndiag, pitch, x, y, m, n, k,
                                block, stream);
}

int cusp_dia_band_spmm_f32(const void* data, const void* offsets, int ndiag,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int k, int block,
                           void* stream) {
  return launch_band<float, float>(data, offsets, ndiag, pitch, x_pad, left,
                                   row0, y, band, k, block, stream);
}

int cusp_dia_band_spmm_bf16(const void* data, const void* offsets, int ndiag,
                            long long pitch, const void* x_pad, long long left,
                            long long row0, void* y, int band, int k, int block,
                            void* stream) {
  return launch_band<__nv_bfloat16, float>(data, offsets, ndiag, pitch, x_pad,
                                           left, row0, y, band, k, block,
                                           stream);
}

int cusp_dia_band_spmm_f64(const void* data, const void* offsets, int ndiag,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int k, int block,
                           void* stream) {
  return launch_band<double, double>(data, offsets, ndiag, pitch, x_pad, left,
                                     row0, y, band, k, block, stream);
}

}  // extern "C"
