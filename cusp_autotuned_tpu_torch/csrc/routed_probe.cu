// The routed probe: the routed SpMV's row walk (rail_rows.cuh, as
// routed_spmv.cu launches it) with its parts taken away one at a time, to
// find where the routed SpMV's time goes.
//
// Replaces the JAX package's Pallas probe _probe_kernel
// (benchmarks/routed_probe.py:44, launched at :116).  On the TPU the stages
// were in-lane takes (full, noperm, nog2, onetake, loads, :64-85).  The
// port's routed kernel has other parts: a walk of the short and long rows
// that gathers x through L1/L2, and the colsort2 hub pair for the rows
// above thr (routed_spmv.cu:1-32).  The mode is rail_rows.cuh's template
// parameter, so each mode compiles to its own kernel, and kFullMode's body
// is the one routed_spmv_kernel runs:
//
//   kFullMode   the shipped body (the wrapper launches the hub pair after
//               it, as the shipped wrapper does): its output equals
//               routed_spmv's bit for bit;
//   kNoHub      the shipped body; the hub pair is not launched, and the
//               hub rows' y is written 0 here instead;
//   kLoads      y[r] = sum of val[e] + 1e-30 col[e] over the row's entries:
//               values and indices streamed, x not read, hub rows 0 (the
//               JAX probe's loads, routed_probe.py:65-66): the traffic
//               floor.
//
// Bound by bytes, as the shipped kernel: per entry a value and a column
// index, the gathered x, two indptr reads a row and y once.
#include "rail_rows.cuh"

namespace {

constexpr int kMaxBlock = 1024;

template <int M>
__global__ void routed_probe_kernel(const int* __restrict__ indptr,
                                    const int* __restrict__ col,
                                    const float* __restrict__ val,
                                    const float* __restrict__ x,
                                    float* __restrict__ y, int m, int thr,
                                    const int* __restrict__ long_rows,
                                    int n_long, int short_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  rail::rows_body<M, float, float>(indptr, col, val, x, y, m, thr,
                                   rail::kNoPlanes, long_rows, n_long,
                                   short_blocks, reinterpret_cast<float*>(smem_raw));
}

template <int M>
int launch(const int* indptr, const int* col, const float* val, const float* x,
           float* y, int m, int thr, const int* long_rows, int n_long, int block,
           cudaStream_t stream) {
  int short_blocks = 0;
  const long long blocks = rail::grid_blocks(m, n_long, block, &short_blocks);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const size_t smem = sizeof(float) * rail::kAhead * static_cast<size_t>(block);
  routed_probe_kernel<M><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      indptr, col, val, x, y, m, thr, long_rows, n_long, short_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cusp_routed_probe_f32(const void* indptr_, const void* col_,
                                     const void* val_, const void* x_, void* y_,
                                     int m, int thr, const void* long_rows_,
                                     int n_long, int mode, int block,
                                     void* stream_) {
  if (block % 32 != 0 || block < 32 || block > kMaxBlock || thr < 1 || n_long < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* indptr = static_cast<const int*>(indptr_);
  const int* col = static_cast<const int*>(col_);
  const float* val = static_cast<const float*>(val_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  const int* long_rows = static_cast<const int*>(long_rows_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (mode) {
    case rail::kFullMode:
      return launch<rail::kFullMode>(indptr, col, val, x, y, m, thr, long_rows,
                                     n_long, block, stream);
    case rail::kNoHub:
      return launch<rail::kNoHub>(indptr, col, val, x, y, m, thr, long_rows,
                                  n_long, block, stream);
    case rail::kLoads:
      return launch<rail::kLoads>(indptr, col, val, x, y, m, thr, long_rows,
                                  n_long, block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
