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

// One row band of a DIA matrix, the counterpart of the JAX package's banded
// via_dia plan (parallel/sharded_plans.py:105, its pallas_call at :154 on
// _dia_kernel): y[i] = sum_d data[d * pitch + i] * x_pad[left + row0 + i +
// offsets[d]] for the band's rows i < band.  data is the band's (k, band)
// slice, a copy of its own (pitch = band) or a view of the whole matrix's
// data (pitch = its rows).  x_pad is the replicated x padded with `left`
// zeros in front and enough behind, as _dia_kernel reads its shifted window
// (kernels/pallas_dia.py:393): so there is no bounds test here; the wrapper
// checks x_pad's length against the offsets instead.  An out-of-matrix slot
// holds 0 in data and meets a padding 0 in x_pad, so the sum adds 0 where
// dia_spmv_kernel skips the slot, and each row is summed in the same order.
// The same bound by bytes as dia_spmv_kernel.
template <typename Store, typename Acc>
__global__ void dia_band_spmv_kernel(const Store* __restrict__ data,
                                     const int* __restrict__ offsets, int k,
                                     long long pitch,
                                     const Acc* __restrict__ x_pad,
                                     long long base, Acc* __restrict__ y,
                                     int band) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < band; i += stride) {
    const Acc* xi = x_pad + base + i;
    Acc acc = 0;
    for (int d = 0; d < k; ++d)
      acc += to_acc<Acc>(data[d * pitch + i]) * xi[__ldg(offsets + d)];
    y[i] = acc;
  }
}

template <typename Store, typename Acc>
static int launch_band(const void* data, const void* offsets, int k,
                       long long pitch, const void* x_pad, long long left,
                       long long row0, void* y, int band, int block,
                       void* stream) {
  dia_band_spmv_kernel<Store, Acc><<<grid_for(band, block), block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Store*>(data), static_cast<const int*>(offsets), k,
      pitch, static_cast<const Acc*>(x_pad), left + row0, static_cast<Acc*>(y),
      band);
  return static_cast<int>(cudaGetLastError());
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

int cusp_dia_band_spmv_f32(const void* data, const void* offsets, int k,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int block,
                           void* stream) {
  return launch_band<float, float>(data, offsets, k, pitch, x_pad, left, row0,
                                   y, band, block, stream);
}

int cusp_dia_band_spmv_bf16(const void* data, const void* offsets, int k,
                            long long pitch, const void* x_pad, long long left,
                            long long row0, void* y, int band, int block,
                            void* stream) {
  return launch_band<__nv_bfloat16, float>(data, offsets, k, pitch, x_pad,
                                           left, row0, y, band, block, stream);
}

int cusp_dia_band_spmv_f64(const void* data, const void* offsets, int k,
                           long long pitch, const void* x_pad, long long left,
                           long long row0, void* y, int band, int block,
                           void* stream) {
  return launch_band<double, double>(data, offsets, k, pitch, x_pad, left,
                                     row0, y, band, block, stream);
}

}  // extern "C"
