// CSR SpMV, one warp per row (the CSR-vector kernel):
// y[r] = sum_{e in [indptr[r], indptr[r+1])} val[e] * x[col[e]].
//
// Replaces the JAX package's Pallas one-hot kernel, _onehot_kernel
// (kernels/pallas_csr.py:171).  That kernel plans nnz-balanced blocks with
// row and column windows, gathers x and scatters y through one-hot matrix
// products, and carries y across sequential grid steps, all because the TPU
// has no vector gather or scatter.  Hopper gathers natively and runs blocks
// in no order, so none of that carries over: each row belongs to one warp,
// whose lanes stride over the row's entries and meet in a shuffle
// reduction.  No atomics, so the result is the same on every run.
//
// Bound by bytes: per entry a value and a column index, plus the gathered
// x (through L2), indptr, and y once.  Short rows leave most lanes of their
// warp idle; making that faster is later work.
#include "common.cuh"

template <typename Store, typename Acc>
__global__ void csr_spmv_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ col,
                                const Store* __restrict__ val,
                                const Acc* __restrict__ x, Acc* __restrict__ y,
                                int m) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // the row loop is uniform across the warp, so the full-mask shuffles below
  // always see all 32 lanes
  for (long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       r < m; r += warps) {
    const int start = indptr[r];
    const int stop = indptr[r + 1];
    Acc acc = 0;
    for (int e = start + lane; e < stop; e += 32)
      acc += to_acc<Acc>(val[e]) * x[col[e]];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) y[r] = acc;
  }
}

template <typename Store, typename Acc>
static int launch(const void* indptr, const void* col, const void* val,
                  const void* x, void* y, int m, int block, void* stream) {
  // block / 32 rows per block; the block size is a tuning axis
  csr_spmv_kernel<Store, Acc><<<grid_for(32LL * m, block), block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(col),
      static_cast<const Store*>(val), static_cast<const Acc*>(x),
      static_cast<Acc*>(y), m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int cusp_csr_spmv_f32(const void* indptr, const void* col, const void* val,
                      const void* x, void* y, int m, int block,
                      void* stream) {
  return launch<float, float>(indptr, col, val, x, y, m, block, stream);
}

int cusp_csr_spmv_bf16(const void* indptr, const void* col, const void* val,
                       const void* x, void* y, int m, int block,
                       void* stream) {
  return launch<__nv_bfloat16, float>(indptr, col, val, x, y, m, block,
                                      stream);
}

int cusp_csr_spmv_f64(const void* indptr, const void* col, const void* val,
                      const void* x, void* y, int m, int block,
                      void* stream) {
  return launch<double, double>(indptr, col, val, x, y, m, block, stream);
}

}  // extern "C"
