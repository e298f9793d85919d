// The DIA probe: dia_spmv_kernel (dia_spmv.cu) with parts taken out, to
// find what binds the DIA SpMV on the card.  Some modes are wrong on
// purpose: they are probes of time, not products.
//
// Replaces the JAX package's Pallas probe_kernel (benchmarks/dia_probe.py:27,
// launched at :71).  Its modes priced the TPU's lane rolls (noroll,
// oneroll, :36-45), which Hopper does not have; here the modes price what
// this kernel spends beside the streams of data, x and y: the shifted read
// of x and the bounds test.  The mode is a template parameter, so each mode
// compiles to its own kernel with nothing of the others left in it.
//
//   kFull      the shipped kernel's body, unchanged: its output equals
//              dia_spmv_kernel's bit for bit (same order of summation, the
//              same FMA contraction), which is what lets its times stand
//              for the shipped kernel's;
//   kNoShift   every diagonal reads x[i] (the JAX probe's noshift,
//              dia_probe.py:33-34, which reads the block's own rows): no
//              shifted read, the memory floor of the data stream;
//   kNoData    coefficients 1, no data stream: y[i] = sum of x[i + off]
//              over the diagonals in the matrix; 2 m 4 bytes;
//   kNoBounds  x left-padded with zeros, as dia_band_spmv_kernel reads it
//              (dia_spmv.cu:50): no 0 <= j < n test.
//
// Bound by bytes, as the shipped kernel: k m 4 bytes of diagonal data, x
// read and y written once.  One thread a row, the shipped layout, so the
// block-size sweep of the probe script reads the shipped kernel's.
#include "common.cuh"

namespace {

enum Mode { kFull = 0, kNoShift = 1, kNoData = 2, kNoBounds = 3 };

template <int M>
__global__ void dia_probe_kernel(const float* __restrict__ data,
                                 const int* __restrict__ offsets, int k,
                                 long long pitch, const float* __restrict__ x,
                                 float* __restrict__ y, int m, int n,
                                 long long left) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    float acc = 0;
    for (int d = 0; d < k; ++d) {
      if (M == kFull) {
        const long long j = i + __ldg(offsets + d);
        if (j >= 0 && j < n) acc += to_acc<float>(data[d * pitch + i]) * x[j];
      } else if (M == kNoShift) {
        if (i < n) acc += data[d * pitch + i] * x[i];
      } else if (M == kNoData) {
        const long long j = i + __ldg(offsets + d);
        if (j >= 0 && j < n) acc += x[j];
      } else {
        acc += data[d * pitch + i] * x[left + i + __ldg(offsets + d)];
      }
    }
    y[i] = acc;
  }
}

template <int M>
int launch(const void* data, const void* offsets, int k, long long pitch,
           const void* x, void* y, int m, int n, long long left, int block,
           void* stream) {
  dia_probe_kernel<M><<<grid_for(m, block), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(offsets), k,
      pitch, static_cast<const float*>(x), static_cast<float*>(y), m, n, left);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cusp_dia_probe_f32(const void* data, const void* offsets, int k,
                                  long long pitch, const void* x, void* y,
                                  int m, int n, long long left, int mode,
                                  int block, void* stream) {
  if (block % 32 != 0 || block < 32 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kFull:
      return launch<kFull>(data, offsets, k, pitch, x, y, m, n, left, block, stream);
    case kNoShift:
      return launch<kNoShift>(data, offsets, k, pitch, x, y, m, n, left, block,
                              stream);
    case kNoData:
      return launch<kNoData>(data, offsets, k, pitch, x, y, m, n, left, block,
                             stream);
    case kNoBounds:
      return launch<kNoBounds>(data, offsets, k, pitch, x, y, m, n, left, block,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
