// nnz-balanced COO SpMM over a row-sorted entry stream:
// Y[row[e], c] += val[e] * X[col[e], c] for e < nnz, with X (n, k) and Y
// (m, k) row-major and contiguous.
//
// Replaces the JAX package's column-lane-binned Pallas SpMM kernels: the
// main and hub SpMM passes (kernels/pallas_colsort.py:426 and :500, bodies
// _main_spmm_kernel :885 and _hub_spmm_kernel :932) and their streamed
// sites (:751, :831).  On the TPU those loop over the k columns of a VMEM
// block for each column-sorted entry block, with heavy rows in a second
// pass.  Here the entries keep the SpMV kernel's nnz-balanced chunks
// (coo_spmv.cu: 32 * vpt entries each), and lanes span a column tile:
//
//   * a team of T lanes, T the least power of two >= k capped at 32, takes
//     one (chunk, tile); it walks the chunk's entries in order, each entry's
//     row, column index and value read once per tile (a broadcast load for
//     the team), and the lanes read T consecutive values of a row of X;
//   * a row that starts and ends inside the chunk is written directly, a
//     column per lane;
//   * the chunk's first row (which may have begun in the chunk before) and
//     its last row (which may go on in the next) leave as carries: two row
//     slots per chunk, the second -1 where it is not needed, and a partial
//     per slot and column;
//   * a second small kernel folds the carries into Y in chunk order, one
//     thread per (slot, column): the first carry of a row adds every
//     partial of that row, however many chunks the row spans.
//
// A long row is just a long run of chunks, so this one kernel covers the
// main and the hub passes.  No atomics: the same result on every run.  Y must
// be zero on entry (empty rows are never written).  Bound by bytes: per entry
// a row index, a column index and a value per tile, the gathered rows of X
// (through L2), Y once and the carries (8 + 2 * k * sizeof(acc) bytes per
// chunk).  A small k leaves lanes idle: k = 3 runs teams of 4.  Element
// offsets of X, Y and the carries are 64-bit.
#include "common.cuh"

namespace {

template <typename Store, typename Acc>
__global__ void coo_spmm_chunk_kernel(const int* __restrict__ row,
                                      const int* __restrict__ col,
                                      const Store* __restrict__ val,
                                      long long nnz, long long chunk_len,
                                      long long nchunks,
                                      const Acc* __restrict__ x,
                                      Acc* __restrict__ y, int k, int tile,
                                      int ntiles, int* __restrict__ carry_row,
                                      Acc* __restrict__ carry_val) {
  const long long team =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / tile;
  const int lane = static_cast<int>(threadIdx.x) & (tile - 1);
  const long long chunk = team / ntiles;
  const int c = static_cast<int>(team - chunk * ntiles) * tile + lane;
  if (chunk >= nchunks || c >= k) return;
  const bool marks = c == 0;          // one lane per chunk writes the row slots
  const long long begin = chunk * chunk_len;
  const long long end = begin + chunk_len < nnz ? begin + chunk_len : nnz;
  const int first_row = row[begin];
  int cur = first_row;
  Acc acc = 0;
  for (long long e = begin; e < end; ++e) {
    const int r = row[e];
    if (r != cur) {                   // cur ended inside the chunk
      if (cur == first_row) {
        if (marks) carry_row[2 * chunk] = cur;
        carry_val[2 * chunk * k + c] = acc;
      } else {
        y[static_cast<long long>(cur) * k + c] = acc;
      }
      cur = r;
      acc = 0;
    }
    acc += to_acc<Acc>(val[e]) * x[static_cast<long long>(col[e]) * k + c];
  }
  if (cur == first_row) {             // the chunk lies inside one row
    if (marks) {
      carry_row[2 * chunk] = cur;
      carry_row[2 * chunk + 1] = -1;
    }
    carry_val[2 * chunk * k + c] = acc;
  } else {
    if (marks) carry_row[2 * chunk + 1] = cur;
    carry_val[(2 * chunk + 1) * k + c] = acc;
  }
}

template <typename Acc>
__global__ void coo_spmm_fold_kernel(const int* __restrict__ carry_row,
                                     const Acc* __restrict__ carry_val,
                                     long long ncarry, int k,
                                     Acc* __restrict__ y) {
  const long long total = ncarry * k;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long i = t / k;
    const long long c = t - i * k;
    const int r = carry_row[i];
    if (r < 0) continue;
    // the first slot of every chunk is set, so the previous set slot is at
    // i - 1 or i - 2
    int prev = -1;
    if (i >= 1) prev = carry_row[i - 1];
    if (prev < 0 && i >= 2) prev = carry_row[i - 2];
    if (prev == r) continue;          // not the row's first carry
    Acc sum = 0;
    for (long long j = i; j < ncarry; ++j) {
      const int rj = carry_row[j];
      if (rj == r) sum += carry_val[j * k + c];
      else if (rj >= 0) break;
    }
    y[static_cast<long long>(r) * k + c] = sum;
  }
}

template <typename Store, typename Acc>
int launch(const void* row, const void* col, const void* val, long long nnz,
           const void* x, void* y, int k, void* carry_row, void* carry_val,
           int vpt, int block, void* stream) {
  if (vpt < 1 || k < 1 || block % 32 != 0 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nnz <= 0) return 0;
  int tile = 1;
  while (tile < k && tile < 32) tile <<= 1;
  const int ntiles = (k + tile - 1) / tile;
  const long long chunk_len = 32LL * vpt;
  const long long nchunks = (nnz + chunk_len - 1) / chunk_len;
  const long long blocks = (nchunks * ntiles * tile + block - 1) / block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  coo_spmm_chunk_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, 0, s>>>(
      static_cast<const int*>(row), static_cast<const int*>(col),
      static_cast<const Store*>(val), nnz, chunk_len, nchunks,
      static_cast<const Acc*>(x), static_cast<Acc*>(y), k, tile, ntiles,
      static_cast<int*>(carry_row), static_cast<Acc*>(carry_val));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  coo_spmm_fold_kernel<Acc><<<grid_for(2 * nchunks * k, 256), 256, 0, s>>>(
      static_cast<const int*>(carry_row), static_cast<const Acc*>(carry_val),
      2 * nchunks, k, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_coo_spmm_f32(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, int k,
                      void* carry_row, void* carry_val, int vpt, int block,
                      void* stream) {
  return launch<float, float>(row, col, val, nnz, x, y, k, carry_row,
                              carry_val, vpt, block, stream);
}

int cusp_coo_spmm_bf16(const void* row, const void* col, const void* val,
                       long long nnz, const void* x, void* y, int k,
                       void* carry_row, void* carry_val, int vpt, int block,
                       void* stream) {
  return launch<__nv_bfloat16, float>(row, col, val, nnz, x, y, k, carry_row,
                                      carry_val, vpt, block, stream);
}

int cusp_coo_spmm_f64(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, int k,
                      void* carry_row, void* carry_val, int vpt, int block,
                      void* stream) {
  return launch<double, double>(row, col, val, nnz, x, y, k, carry_row,
                                carry_val, vpt, block, stream);
}

}  // extern "C"
