// DIA SpMV: y[i] = sum_d data[d * pitch + i] * x[i + offsets[d]].
//
// Replaces the JAX package's Pallas DIA kernels, _dia_kernel
// (kernels/pallas_dia.py:393) and _dia_streamed_kernel (:240).  On the TPU
// the two differ only in whether x fits in VMEM; here x is read from device
// memory through L2, so one kernel serves both.
//
// Bound by bytes: k * rows * sizeof(store) of diagonal data, plus x read and
// y written once, 2 * m * 4 bytes in f32.  One thread per row walks the k
// diagonals, so the data loads of a warp are 32 consecutive values of one
// diagonal (coalesced), and so are its x loads.  The Pallas kernel found the
// x bound in its zero padding; this kernel checks 0 <= i + off < n itself,
// so x needs no padding.  Sums run in the accumulation type (f32 for f32 and
// bf16 storage, f64 for f64), diagonal by diagonal in offset order, as the
// plain version adds them.  The block size is a tuning axis (the fork's
// BLOCK_SIZE, dia_multiply.h:24-55).
#include "common.cuh"

template <typename Store, typename Acc>
__global__ void dia_spmv_kernel(const Store* __restrict__ data,
                                const int* __restrict__ offsets, int k,
                                long long pitch, const Acc* __restrict__ x,
                                Acc* __restrict__ y, int m, int n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    Acc acc = 0;
    for (int d = 0; d < k; ++d) {
      const long long j = i + __ldg(offsets + d);
      if (j >= 0 && j < n) acc += to_acc<Acc>(data[d * pitch + i]) * x[j];
    }
    y[i] = acc;
  }
}

template <typename Store, typename Acc>
static int launch(const void* data, const void* offsets, int k, long long pitch,
                  const void* x, void* y, int m, int n, int block,
                  void* stream) {
  dia_spmv_kernel<Store, Acc><<<grid_for(m, block), block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Store*>(data), static_cast<const int*>(offsets), k,
      pitch, static_cast<const Acc*>(x), static_cast<Acc*>(y), m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int cusp_dia_spmv_f32(const void* data, const void* offsets, int k,
                      long long pitch, const void* x, void* y, int m, int n,
                      int block, void* stream) {
  return launch<float, float>(data, offsets, k, pitch, x, y, m, n, block,
                              stream);
}

int cusp_dia_spmv_bf16(const void* data, const void* offsets, int k,
                       long long pitch, const void* x, void* y, int m, int n,
                       int block, void* stream) {
  return launch<__nv_bfloat16, float>(data, offsets, k, pitch, x, y, m, n,
                                      block, stream);
}

int cusp_dia_spmv_f64(const void* data, const void* offsets, int k,
                      long long pitch, const void* x, void* y, int m, int n,
                      int block, void* stream) {
  return launch<double, double>(data, offsets, k, pitch, x, y, m, n, block,
                                stream);
}

}  // extern "C"
