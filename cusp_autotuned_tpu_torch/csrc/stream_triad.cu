// Stream triad, in place: y = 0.5 * y + 0.25 * x, f32.
//
// Replaces the JAX package's Pallas probe triad_kernel
// (autotune/calibrate.py:322, launched at :326), which measures the rate at
// which the device streams memory: x and y are read once and y written once,
// three streams of bytes, over a working set much larger than on-chip
// memory (here at least 1 GB against the 50 MB L2).  The rate it gives is
// the denominator of every SpMV bound in the port.
//
// Bound by bytes (12 per element); two flops per element are nothing
// beside them.  Each thread moves 16 bytes per load and store (float4),
// neighbouring threads on neighbouring addresses, in a grid-stride loop; the
// wrapper guarantees 16-byte aligned pointers, and the last n % 4 elements
// are done one by one.
#include "common.cuh"

__global__ void stream_triad_kernel(const float4* __restrict__ x,
                                    float4* __restrict__ y, long long n4,
                                    const float* __restrict__ x_tail,
                                    float* __restrict__ y_tail, int tail) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < n4; i += stride) {
    const float4 a = x[i];
    float4 b = y[i];
    b.x = 0.5f * b.x + 0.25f * a.x;
    b.y = 0.5f * b.y + 0.25f * a.y;
    b.z = 0.5f * b.z + 0.25f * a.z;
    b.w = 0.5f * b.w + 0.25f * a.w;
    y[i] = b;
  }
  if (first < tail) y_tail[first] = 0.5f * y_tail[first] + 0.25f * x_tail[first];
}

extern "C" int cusp_stream_triad_f32(const void* x, void* y, long long n,
                                     int block, void* stream) {
  if (block % 32 != 0 || block > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long n4 = n / 4;
  const int tail = static_cast<int>(n - 4 * n4);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  stream_triad_kernel<<<grid_for(n4 > 0 ? n4 : 1, block), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4,
      xf + 4 * n4, yf + 4 * n4, tail);
  return static_cast<int>(cudaGetLastError());
}
