// Helpers shared by the SpMV kernels.
#pragma once

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

// Blocks for `threads` work items at `block` threads each.  The kernels walk
// a grid-stride loop, so the grid is capped: past the cap each thread takes
// several items.
inline unsigned grid_for(long long threads, int block) {
  long long blocks = (threads + block - 1) / block;
  const long long cap = 1 << 16;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}
