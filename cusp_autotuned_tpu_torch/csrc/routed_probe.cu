// The routed probe: routed_spmv_kernel (routed_spmv.cu) with its stages
// taken away one at a time, to find where the routed SpMV's time goes.
//
// Replaces the JAX package's Pallas probe _probe_kernel
// (benchmarks/routed_probe.py:44, launched at :116).  On the TPU the stages
// were in-lane takes (full, noperm, nog2, onetake, loads, :64-85).  The
// port's routed kernel has other stages: it stages each planned window of x
// in shared memory, reads the other entries' x through L2, and leaves the
// rows above thr to the colsort2 hub pair (routed_spmv.cu:1-35).  The mode
// is a template parameter, so each mode compiles to its own kernel:
//
//   kFull       the shipped kernel's body, unchanged (the wrapper launches
//               the hub pair after it, as the shipped wrapper does): its
//               output equals routed_spmv's bit for bit;
//   kNoStage    no window staged, every entry read from x through L2; the
//               sum is the same, in the same order (a thread adds its row's
//               entries in column order either way), and so is the output;
//   kStageOnly  only the entries of staged windows are added; the direct
//               gathers are skipped (their column indices are still read,
//               to step over them): wrong on purpose;
//   kNoHub      the shipped body; the hub pair is not launched, and the
//               hub rows' y is written 0 here instead;
//   kLoads      y[r] = sum of val[e] + 1e-30 col[e] over the row's entries:
//               values and indices streamed, x not read, no window staged,
//               hub rows 0 (the JAX probe's loads, routed_probe.py:65-66):
//               the traffic floor.
//
// Bound by bytes, as the shipped kernel: per entry a value and a column
// index, x once per staged window and row block plus the gathered entries,
// two indptr reads a row and y once.  The modes that stage nothing launch
// with no shared memory, as a kernel without staging would.
#include "common.cuh"

namespace {

enum Mode { kFull = 0, kNoStage = 1, kStageOnly = 2, kNoHub = 3, kLoads = 4 };
constexpr int kMaxBlock = 1024;
constexpr int kMaxSmem = 128 * 1024;

template <int M>
__global__ void routed_probe_kernel(const int* __restrict__ indptr,
                                    const int* __restrict__ col,
                                    const float* __restrict__ val,
                                    const float* __restrict__ x,
                                    float* __restrict__ y, int m, int n, int thr,
                                    const int* __restrict__ win_ptr,
                                    const int* __restrict__ win_ids, int W) {
  extern __shared__ unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  const int rb = blockIdx.x;
  const long long r = static_cast<long long>(rb) * blockDim.x + threadIdx.x;
  int p = 0, stop = 0;
  bool own = false;
  if (r < m) {
    p = indptr[r];
    stop = indptr[r + 1];
    own = stop - p <= thr;
  }
  if (!own) stop = p;                 // a hub row or no row: nothing to walk
  float acc = 0;
  if (M == kLoads) {
    for (; p < stop; ++p) acc += val[p] + 1e-30f * static_cast<float>(col[p]);
  } else if (M == kNoStage) {
    for (; p < stop; ++p) acc += to_acc<float>(val[p]) * x[col[p]];
  } else {
    for (int wi = win_ptr[rb]; wi < win_ptr[rb + 1]; ++wi) {
      const int c0 = win_ids[wi] * W;
      const int width = min(W, n - c0);
      if (M == kStageOnly) {
        for (; p < stop && col[p] < c0; ++p) {
        }
      } else {
        for (; p < stop && col[p] < c0; ++p) acc += to_acc<float>(val[p]) * x[col[p]];
      }
      __syncthreads();                // the previous window is consumed
      for (int i = threadIdx.x; i < width; i += blockDim.x) xs[i] = x[c0 + i];
      __syncthreads();
      for (; p < stop && col[p] < c0 + width; ++p)
        acc += to_acc<float>(val[p]) * xs[col[p] - c0];
    }
    if (M != kStageOnly)
      for (; p < stop; ++p) acc += to_acc<float>(val[p]) * x[col[p]];
  }
  if (own) {
    y[r] = acc;
  } else if ((M == kNoHub || M == kLoads) && r < m) {
    y[r] = 0;
  }
}

template <int M>
int launch(const int* indptr, const int* col, const float* val, const float* x,
           float* y, int m, int n, int thr, const int* win_ptr,
           const int* win_ids, int W, int block, cudaStream_t stream) {
  const bool stages = M != kNoStage && M != kLoads;
  const size_t smem = stages ? static_cast<size_t>(W) * sizeof(float) : 0;
  if (stages) {
    static bool configured = false;   // once per instantiation, before any capture
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          routed_probe_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
  }
  const long long blocks = (static_cast<long long>(m) + block - 1) / block;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  routed_probe_kernel<M><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      indptr, col, val, x, y, m, n, thr, win_ptr, win_ids, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cusp_routed_probe_f32(const void* indptr_, const void* col_,
                                     const void* val_, const void* x_, void* y_,
                                     int m, int n, int thr,
                                     const void* win_ptr_, const void* win_ids_,
                                     int W, int mode, int block, void* stream_) {
  if (W < 1 || static_cast<long long>(W) * 4 > kMaxSmem || block % 32 != 0 ||
      block < 32 || block > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* indptr = static_cast<const int*>(indptr_);
  const int* col = static_cast<const int*>(col_);
  const float* val = static_cast<const float*>(val_);
  const float* x = static_cast<const float*>(x_);
  float* y = static_cast<float*>(y_);
  const int* win_ptr = static_cast<const int*>(win_ptr_);
  const int* win_ids = static_cast<const int*>(win_ids_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (mode) {
    case kFull:
      return launch<kFull>(indptr, col, val, x, y, m, n, thr, win_ptr, win_ids,
                           W, block, stream);
    case kNoStage:
      return launch<kNoStage>(indptr, col, val, x, y, m, n, thr, win_ptr,
                              win_ids, W, block, stream);
    case kStageOnly:
      return launch<kStageOnly>(indptr, col, val, x, y, m, n, thr, win_ptr,
                                win_ids, W, block, stream);
    case kNoHub:
      return launch<kNoHub>(indptr, col, val, x, y, m, n, thr, win_ptr, win_ids,
                            W, block, stream);
    case kLoads:
      return launch<kLoads>(indptr, col, val, x, y, m, n, thr, win_ptr, win_ids,
                            W, block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
