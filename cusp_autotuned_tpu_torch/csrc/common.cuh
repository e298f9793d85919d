// Helpers shared by the SpMV kernels.
#pragma once

#include <cstdint>

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
