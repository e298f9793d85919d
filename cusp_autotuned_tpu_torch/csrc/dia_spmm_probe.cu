// The DIA SpMM probe: dia_spmm_kernel (dia_spmm.cu) and variants of it, to
// find what holds the DIA SpMM kernel (first at a quarter of the triad's
// rate).
//
// Replaces the JAX package's Pallas probe _kernel
// (benchmarks/dia_spmm_probe.py:29, launched at :68), which set a
// concatenated block of X (:32-33) against per-diagonal slices (:38-45) and
// swept the block size through the TPU's VMEM budget (:56-58).  On Hopper
// the questions are how the threads span the columns of X, and whether the
// rows of X that several diagonals read come from shared memory or again
// from L1/L2.  Every mode but kNoData computes the shipped kernel's
// function, each element's diagonals summed in offset order with the same
// FMAs, so its output equals the shipped kernel's bit for bit:
//
//   kShipped  dia_spmm_kernel's body (dia_spmm_body.cuh) at the W, C, R
//             and team the wrapper gives: the shipped schedule, or the
//             shipped one with R rows a lane (rows=R, R = 1, 2 or 4);
//   kTeam     a warp a row, each lane taking T / 32 consecutive columns
//             (T = 32, 64 or 128), with 8- or 16-byte loads and stores
//             where k is a multiple of T / 32;
//   kXTile    a block owns R rows and a tile of CT = min(128,
//             next_pow2(k)) columns; for each cluster of offsets that lie
//             within R of the cluster's first (on poisson5pt {-1, 0, +1},
//             and -1000 and +1000 alone), the rows of X under the block's
//             rows are staged once in dynamic shared memory and read there
//             by every diagonal of the cluster.  A tile of the whole band
//             does not fit: poisson's +-1000 offsets put 2000 rows of X
//             (1 MB at k = 128) between the far diagonals, against 227 KB
//             of shared memory a block, so it stages clusters.  Shared
//             memory is at most 2 R CT 4 bytes = 64 B a thread (64 KB at
//             1024 threads), set above the default 48 KB once;
//   kNoData   the shipped body and schedule with coefficients 1: no data
//             stream.
//
// Bound by bytes, as the shipped kernel: ndiag m 4 bytes of diagonal data,
// X read once (n k 4) and Y written once (m k 4).  Element offsets of X
// and Y are 64-bit: 1M rows at k = 128 is 512 MB, and n k passes 2^31.
#include "dia_spmm_body.cuh"

namespace {

enum Mode { kShipped = 0, kTeam = 1, kXTile = 2, kNoData = 3 };
constexpr int kXTileRows = 8;              // rows a thread owns in kXTile
constexpr int kMaxBlock = 1024;
constexpr int kMaxSmem = 2 * kMaxBlock * kXTileRows * 4;

template <int V>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// A warp a row; lane l takes the V columns from c = tile * 32 V + l V.
template <int V>
__device__ __forceinline__ void team_body(const float* __restrict__ data,
                                          const int* __restrict__ offsets,
                                          int ndiag, long long pitch,
                                          const float* __restrict__ x,
                                          float* __restrict__ y, int m, int n,
                                          int k) {
  const long long i = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  const int c = static_cast<int>(blockIdx.y) * 32 * V + (threadIdx.x & 31) * V;
  if (i >= m || c >= k) return;
  if constexpr (V > 1) {
    if (k % V == 0) {                      // whole vectors, aligned
      using T = typename Vec<V>::T;
      float acc[V] = {};
      for (int d = 0; d < ndiag; ++d) {
        const long long j = i + __ldg(offsets + d);
        if (j >= 0 && j < n) {
          const float a = data[d * pitch + i];
          const T v = *reinterpret_cast<const T*>(x + j * k + c);
          const float* vs = reinterpret_cast<const float*>(&v);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += a * vs[e];
        }
      }
      T out;
      float* os = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int e = 0; e < V; ++e) os[e] = acc[e];
      *reinterpret_cast<T*>(y + i * k + c) = out;
      return;
    }
  }
  float acc[V] = {};
  for (int d = 0; d < ndiag; ++d) {
    const long long j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) {
      const float a = data[d * pitch + i];
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c + e < k) acc[e] += a * x[j * k + c + e];
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (c + e < k) y[i * k + c + e] = acc[e];
}

// A block owns R = (block / CT) * kXTileRows rows from i0 and the CT
// columns of tile blockIdx.y; thread t owns column t % CT of the rows
// i0 + t / CT + e * (block / CT), e < kXTileRows.
__device__ __forceinline__ void xtile_body(const float* __restrict__ data,
                                           const int* __restrict__ offsets,
                                           int ndiag, long long pitch,
                                           const float* __restrict__ x,
                                           float* __restrict__ y, int m, int n,
                                           int k, int ct_shift, float* xs) {
  const int ct = 1 << ct_shift;
  const int pass = blockDim.x >> ct_shift;          // rows a pass
  const int R = pass * kXTileRows;
  const long long i0 = static_cast<long long>(blockIdx.x) * R;
  const int cl = threadIdx.x & (ct - 1);
  const int rl = threadIdx.x >> ct_shift;
  const int c = static_cast<int>(blockIdx.y) * ct + cl;
  float acc[kXTileRows] = {};
  for (int d0 = 0; d0 < ndiag;) {
    // the cluster [d0, d1): offsets within R of the first
    const int lo = __ldg(offsets + d0);
    int hi = lo, d1 = d0 + 1;
    while (d1 < ndiag) {
      const int off = __ldg(offsets + d1);
      if (off < lo || off - lo > R) break;
      hi = max(hi, off);
      ++d1;
    }
    const int rows = R + hi - lo;                   // X rows i0 + lo ...
    __syncthreads();                                // the last cluster is read
    for (int t = rl; t < rows; t += pass) {
      const long long j = i0 + lo + t;
      xs[t * ct + cl] = (j >= 0 && j < n && c < k) ? x[j * k + c] : 0.f;
    }
    __syncthreads();
    for (int d = d0; d < d1; ++d) {
      const int off = __ldg(offsets + d);
#pragma unroll
      for (int e = 0; e < kXTileRows; ++e) {
        const long long i = i0 + rl + e * pass;
        const long long j = i + off;
        if (i < m && j >= 0 && j < n)
          acc[e] += to_acc<float>(data[d * pitch + i]) *
                    xs[(rl + e * pass + off - lo) * ct + cl];
      }
    }
    d0 = d1;
  }
  if (c >= k) return;
#pragma unroll
  for (int e = 0; e < kXTileRows; ++e) {
    const long long i = i0 + rl + e * pass;
    if (i < m) y[i * k + c] = acc[e];
  }
}

// One kernel name for every mode, so that a trace finds each launch under
// it: M the mode; in kShipped and kNoData the body's W, C and R, and shift
// the log2 of the team; V the columns a lane takes in kTeam; in kXTile
// shift the log2 of the column tile.
template <int M, int V, int W = 1, int C = 1, int R = 1>
__global__ void dia_spmm_probe_kernel(const float* __restrict__ data,
                                      const int* __restrict__ offsets,
                                      int ndiag, long long pitch,
                                      const float* __restrict__ x,
                                      float* __restrict__ y, int m, int n,
                                      int k, int shift) {
  extern __shared__ float xs[];
  if constexpr (M == kShipped || M == kNoData) {
    long long i0;
    int c0;
    if (spmm_owner<C, R>(m, k, shift, &i0, &c0))
      dia_spmm_rows<float, float, W, C, R, false, M == kNoData>(
          data, offsets, ndiag, pitch, x, 0, n, y, m, k, i0, c0);
  } else if constexpr (M == kTeam) {
    team_body<V>(data, offsets, ndiag, pitch, x, y, m, n, k);
  } else {
    xtile_body(data, offsets, ndiag, pitch, x, y, m, n, k, shift, xs);
  }
}

// The kShipped or kNoData kernel at the runtime (width, cols, rows).
template <int M>
int launch_body(const float* data, const int* offsets, int ndiag,
                long long pitch, const float* x, float* y, int m, int n, int k,
                int width, int cols, int rows, int team_shift, int block,
                cudaStream_t stream) {
  dim3 grid;
  if (!spmm_grid(m, k, cols, rows, team_shift, block, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_width<float>(width, cols, [&](auto w, auto c) {
    constexpr int W = decltype(w)::value, C = decltype(c)::value;
    if (rows == 1)
      dia_spmm_probe_kernel<M, 1, W, C, 1><<<grid, block, 0, stream>>>(
          data, offsets, ndiag, pitch, x, y, m, n, k, team_shift);
    else if (rows == 2)
      dia_spmm_probe_kernel<M, 1, W, C, 2><<<grid, block, 0, stream>>>(
          data, offsets, ndiag, pitch, x, y, m, n, k, team_shift);
    else if (rows == 4)
      dia_spmm_probe_kernel<M, 1, W, C, 4><<<grid, block, 0, stream>>>(
          data, offsets, ndiag, pitch, x, y, m, n, k, team_shift);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  });
}

int shift_for(int k, int cap_shift) {
  int shift = 0;
  while ((1 << shift) < k && shift < cap_shift) ++shift;
  return shift;
}

int grid_ok(long long blocks, long long tiles, dim3* grid) {
  if (blocks > 0x7fffffffLL || tiles > 65535) return 0;
  *grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  return 1;
}

}  // namespace

extern "C" int cusp_dia_spmm_probe_f32(const void* data_, const void* offsets_,
                                       int ndiag, long long pitch,
                                       const void* x_, void* y_, int m, int n,
                                       int k, int mode, int team, int width,
                                       int cols, int rows, int team_shift,
                                       int block, void* stream_) {
  if (k < 1 || block % 32 != 0 || block < 32 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const float* data = static_cast<const float*>(data_);
  const int* offsets = static_cast<const int*>(offsets_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  dim3 grid;
  if (mode == kShipped || mode == kNoData) {
    return (mode == kShipped ? launch_body<kShipped> : launch_body<kNoData>)(
        data, offsets, ndiag, pitch, x, y, m, n, k, width, cols, rows,
        team_shift, block, stream);
  } else if (mode == kTeam) {
    if (team != 32 && team != 64 && team != 128)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = block >> 5;
    if (!grid_ok((m + rows - 1) / rows, (k + team - 1) / team, &grid))
      return static_cast<int>(cudaErrorInvalidValue);
    if (team == 32)
      dia_spmm_probe_kernel<kTeam, 1><<<grid, block, 0, stream>>>(
          data, offsets, ndiag, pitch, x, y, m, n, k, 5);
    else if (team == 64)
      dia_spmm_probe_kernel<kTeam, 2><<<grid, block, 0, stream>>>(
          data, offsets, ndiag, pitch, x, y, m, n, k, 5);
    else
      dia_spmm_probe_kernel<kTeam, 4><<<grid, block, 0, stream>>>(
          data, offsets, ndiag, pitch, x, y, m, n, k, 5);
  } else if (mode == kXTile) {
    static bool configured = false;  // once, before any capture
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          dia_spmm_probe_kernel<kXTile, 1>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    const int shift = shift_for(k, 7);
    if ((1 << shift) > block) return static_cast<int>(cudaErrorInvalidValue);
    const long long R = static_cast<long long>(block >> shift) * kXTileRows;
    if (!grid_ok((m + R - 1) / R, (k + (1 << shift) - 1) >> shift, &grid))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(2 * R) * (1 << shift) * sizeof(float);
    dia_spmm_probe_kernel<kXTile, 1><<<grid, block, smem, stream>>>(
        data, offsets, ndiag, pitch, x, y, m, n, k, shift);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
