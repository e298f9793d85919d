// nnz-balanced COO SpMV over a row-sorted entry stream:
// y[row[e]] += val[e] * x[col[e]] for e < nnz.
//
// Replaces the JAX package's column-lane-binned Pallas kernels at their SpMV
// sites: _main_kernel (kernels/pallas_colsort.py:162), _hub_kernel (:274),
// _main_streamed_kernel (:558) and _hub_streamed_kernel (:615).  On the TPU
// the entries are column-sorted so that the in-lane take can gather x, heavy
// rows take a second (hub) pass, and the streamed forms exist because x
// outgrew VMEM.  Hopper gathers natively, so the kernel is the fork's COO
// family instead (coo_kernel.h:64-369, the warp-scan segmented reduce):
//
//   * the entries, sorted by row, are cut into chunks of 32 * vpt; one warp
//     walks its chunk 32 entries at a time and adds them up with a segmented
//     inclusive scan on the row keys (__shfl_up_sync), carrying the open
//     row's sum from one batch of 32 to the next;
//   * a row that starts and ends inside a chunk is written directly;
//   * the chunk's first row (which may have begun in the chunk before) and
//     its last row (which may go on in the next) leave as (row, partial)
//     carries, two slots per chunk, the second -1 where it is not needed;
//   * a second small kernel folds the carries into y in chunk order: the
//     first carry of each row adds every partial of that row, however many
//     chunks the row spans.
//
// A long row is just a long segment, so this one kernel covers the main and
// the hub passes.  No atomics: the result is the same on every run.  y must
// be zero on entry (empty rows are never written).  Bound by bytes: per entry
// a row index, a column index and a value, plus the gathered x (through L2),
// y once and the carries (16 bytes per chunk).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename Store, typename Acc>
__global__ void coo_chunk_kernel(const int* __restrict__ row,
                                 const int* __restrict__ col,
                                 const Store* __restrict__ val, long long nnz,
                                 int vpt, long long nchunks,
                                 const Acc* __restrict__ x, Acc* __restrict__ y,
                                 int* __restrict__ carry_row,
                                 Acc* __restrict__ carry_val) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (w >= nchunks) return;           // uniform across the warp
  const long long begin = w * 32LL * vpt;
  const int first_row = row[begin];
  int carry_r = -1;                   // the open row at the end of a batch
  Acc carry_v = 0;

  for (int it = 0; it < vpt; ++it) {
    const long long e = begin + 32LL * it + lane;
    int r = -1;
    Acc v = 0;
    if (e < nnz) {
      r = row[e];
      v = to_acc<Acc>(val[e]) * x[col[e]];
    }
    // the open row ended with the last batch: flush it
    const int r0 = __shfl_sync(kFull, r, 0);
    if (lane == 0 && carry_r >= 0 && r0 != carry_r) {
      if (carry_r == first_row) {
        carry_row[2 * w] = carry_r;
        carry_val[2 * w] = carry_v;
      } else {
        y[carry_r] = carry_v;
      }
    }
    // segmented inclusive scan: rows are sorted, so equal keys are adjacent
    for (int off = 1; off < 32; off <<= 1) {
      const Acc vo = __shfl_up_sync(kFull, v, off);
      const int ro = __shfl_up_sync(kFull, r, off);
      if (lane >= off && ro == r) v += vo;
    }
    if (r == carry_r) v += carry_v;
    const int r_next = __shfl_down_sync(kFull, r, 1);
    if (lane < 31 && r >= 0 && r_next != r) {
      if (r == first_row) {
        carry_row[2 * w] = r;
        carry_val[2 * w] = v;
      } else {
        y[r] = v;
      }
    }
    carry_r = __shfl_sync(kFull, r, 31);
    carry_v = __shfl_sync(kFull, v, 31);
  }
  if (lane == 0) {
    if (carry_r == first_row) {
      carry_row[2 * w] = carry_r;
      carry_val[2 * w] = carry_v;
      carry_row[2 * w + 1] = -1;
    } else {
      carry_row[2 * w + 1] = carry_r;   // -1 where the last batch ran out
      carry_val[2 * w + 1] = carry_v;
    }
  }
}

template <typename Acc>
__global__ void coo_fold_kernel(const int* __restrict__ carry_row,
                                const Acc* __restrict__ carry_val,
                                long long ncarry, Acc* __restrict__ y) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < ncarry; i += stride) {
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
      if (rj == r) sum += carry_val[j];
      else if (rj >= 0) break;
    }
    y[r] = sum;
  }
}

template <typename Store, typename Acc>
int launch(const void* row, const void* col, const void* val, long long nnz,
           const void* x, void* y, void* carry_row, void* carry_val, int vpt,
           int block, void* stream) {
  if (vpt < 1 || block % 32 != 0 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nnz <= 0) return 0;
  const long long nchunks = (nnz + 32LL * vpt - 1) / (32LL * vpt);
  const long long blocks = (32 * nchunks + block - 1) / block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  coo_chunk_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, 0, s>>>(
      static_cast<const int*>(row), static_cast<const int*>(col),
      static_cast<const Store*>(val), nnz, vpt, nchunks,
      static_cast<const Acc*>(x), static_cast<Acc*>(y),
      static_cast<int*>(carry_row), static_cast<Acc*>(carry_val));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  coo_fold_kernel<Acc><<<grid_for(2 * nchunks, 256), 256, 0, s>>>(
      static_cast<const int*>(carry_row), static_cast<const Acc*>(carry_val),
      2 * nchunks, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_coo_spmv_f32(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, void* carry_row,
                      void* carry_val, int vpt, int block, void* stream) {
  return launch<float, float>(row, col, val, nnz, x, y, carry_row, carry_val,
                              vpt, block, stream);
}

int cusp_coo_spmv_bf16(const void* row, const void* col, const void* val,
                       long long nnz, const void* x, void* y, void* carry_row,
                       void* carry_val, int vpt, int block, void* stream) {
  return launch<__nv_bfloat16, float>(row, col, val, nnz, x, y, carry_row,
                                      carry_val, vpt, block, stream);
}

int cusp_coo_spmv_f64(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, void* carry_row,
                      void* carry_val, int vpt, int block, void* stream) {
  return launch<double, double>(row, col, val, nnz, x, y, carry_row, carry_val,
                                vpt, block, stream);
}

}  // extern "C"
