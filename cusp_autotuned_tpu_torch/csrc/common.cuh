// Helpers shared by the SpMV and SpMM kernels.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Widen a stored value to the accumulation type (bf16 storage accumulates
// in f32, like _upcast in the JAX package's pallas_dia.py).
template <typename Acc, typename Store>
__device__ __forceinline__ Acc to_acc(Store v) { return static_cast<Acc>(v); }

template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a * b + c rounded once: the FMA every SpMM sum takes, spelled out so that
// kernels that must agree bit for bit do not rest on the compiler's
// contraction of a * b + c.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Four consecutive stored values, widened (16-byte loads for f32 and f64,
// 8 bytes for bf16); p is aligned to four values.
template <typename Store, typename Acc>
__device__ __forceinline__ void load4(const Store* p, Acc v[4]);

template <>
__device__ __forceinline__ void load4<float, float>(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16, float>(const __nv_bfloat16* p,
                                                            float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&q);
  v[0] = __bfloat162float(b[0]); v[1] = __bfloat162float(b[1]);
  v[2] = __bfloat162float(b[2]); v[3] = __bfloat162float(b[3]);
}

template <>
__device__ __forceinline__ void load4<double, double>(const double* p, double v[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Blocks for `threads` work items at `block` threads each.  The kernels walk
// a grid-stride loop, so the grid is capped: past the cap each thread takes
// several items.
inline unsigned grid_for(long long threads, int block) {
  long long blocks = (threads + block - 1) / block;
  const long long cap = 1 << 16;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

// Rows of a dense block, W values of the accumulation type at a load or
// store (16 bytes where W * sizeof(Acc) is 16): the SpMM kernels' columns.
template <typename Acc, int W>
struct VecOf;
template <>
struct VecOf<float, 1> { using T = float; };
template <>
struct VecOf<float, 2> { using T = float2; };
template <>
struct VecOf<float, 4> { using T = float4; };
template <>
struct VecOf<double, 1> { using T = double; };
template <>
struct VecOf<double, 2> { using T = double2; };

// C consecutive values from p, W at a time (p aligned to W values).
template <typename Acc, int W, int C>
__device__ __forceinline__ void load_cols(const Acc* p, Acc (&v)[C]) {
  using T = typename VecOf<Acc, W>::T;
#pragma unroll
  for (int q = 0; q < C; q += W) {
    const T t = __ldg(reinterpret_cast<const T*>(p + q));
    const Acc* e = reinterpret_cast<const Acc*>(&t);
#pragma unroll
    for (int w = 0; w < W; ++w) v[q + w] = e[w];
  }
}

template <typename Acc, int W, int C>
__device__ __forceinline__ void store_cols(Acc* p, const Acc (&v)[C]) {
  using T = typename VecOf<Acc, W>::T;
#pragma unroll
  for (int q = 0; q < C; q += W) {
    T t;
    Acc* e = reinterpret_cast<Acc*>(&t);
#pragma unroll
    for (int w = 0; w < W; ++w) e[w] = v[q + w];
    *reinterpret_cast<T*>(p + q) = t;
  }
}

// f(W, C) as integral constants for the runtime (width, cols), among the
// pairs the wrapper picks whose loads are at most 16 bytes of Acc; else
// cudaErrorInvalidValue.
template <typename Acc, typename F>
int with_width(int width, int cols, F&& f) {
#define CUSP_SPMM_CASE(W_, C_)                                               \
  if constexpr (W_ * sizeof(Acc) <= 16) {                                    \
    if (width == W_ && cols == C_)                                           \
      return f(std::integral_constant<int, W_>{},                            \
               std::integral_constant<int, C_>{});                           \
  }
  CUSP_SPMM_CASE(1, 1)
  CUSP_SPMM_CASE(1, 2)
  CUSP_SPMM_CASE(2, 2)
  CUSP_SPMM_CASE(1, 3)
  CUSP_SPMM_CASE(1, 4)
  CUSP_SPMM_CASE(2, 4)
  CUSP_SPMM_CASE(4, 4)
#undef CUSP_SPMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
