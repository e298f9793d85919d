// nnz-balanced COO SpMV over a row-sorted entry stream:
// y[row[e]] += val[e] * x[col[e]] for e < nnz, every row of y written.
//
// Replaces the JAX package's column-lane-binned Pallas kernels at their SpMV
// sites: _main_kernel (kernels/pallas_colsort.py:162), _hub_kernel (:274),
// _main_streamed_kernel (:558) and _hub_streamed_kernel (:615).  On the TPU
// the entries are column-sorted so that the in-lane take can gather x, heavy
// rows take a second (hub) pass, and the streamed forms exist because x
// outgrew VMEM.  Hopper gathers natively, so the kernel is a reduce-by-key
// in the style of the fork's COO family (coo_kernel.h) and of merge-path:
//
//   * the entries, sorted by row, are cut into chunks of 32 * vpt, one a
//     warp; each lane adds up vpt consecutive entries in registers (16-byte
//     loads of row, col and val where vpt % 4 == 0), writing every row that
//     starts and ends inside its run directly;
//   * one segmented scan over the lanes' last partials (5 shuffle steps a
//     chunk, where the first version scanned every 32 entries) joins the
//     rows that cross lanes;
//   * the chunk's first row (which may have begun in the chunk before)
//     leaves as a (row, partial) carry in slot 2w, and a last row that runs
//     on into the next chunk in slot 2w + 1 (-1 where there is none);
//   * every row of y is written: a lane that sees a gap between consecutive
//     keys writes the rows between as 0, the first chunk the rows before
//     row[0], the last lane the rows after the last key, so y needs no
//     zero fill.  A lane writes a gap of at most kGapRows rows, one row at
//     a time; where a longer run of empty rows exists the plan zero-fills
//     y before the launch (kernels/colsort.py, GAP_ROWS), so no lane walks
//     a long run alone;
//   * a second small kernel folds the carries into y in chunk order: the
//     first carry of each row adds every partial of that row, however many
//     chunks the row spans.
//
// A long row is just a long segment, so this one kernel covers the main and
// the hub passes.  No atomics: the result is the same on every run.  Bound
// by bytes: per entry a row index, a column index and a value, plus the
// gathered x (through L2), y once and the carries (16 bytes per chunk).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kGapRows = 32;    // GAP_ROWS in kernels/colsort.py

// The empty rows [from, to), where they are at most kGapRows; a longer run
// was zeroed before the launch.
template <typename Acc>
__device__ __forceinline__ void zero_gap(Acc* y, int from, int to) {
  if (to - from <= kGapRows)
    for (int z = from; z < to; ++z) y[z] = 0;
}

template <typename Store, typename Acc>
__global__ void coo_chunk_kernel(const int* __restrict__ row,
                                 const int* __restrict__ col,
                                 const Store* __restrict__ val, long long nnz,
                                 int vpt, long long nchunks, bool vec,
                                 const Acc* __restrict__ x, Acc* __restrict__ y,
                                 int m, int* __restrict__ carry_row,
                                 Acc* __restrict__ carry_val) {
  const int lane = threadIdx.x & 31;
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (w >= nchunks) return;           // uniform across the warp
  const long long begin = w * 32LL * vpt, end = begin + 32LL * vpt;
  const long long e0 = begin + static_cast<long long>(lane) * vpt;
  const long long rest = nnz - e0;
  const int n_here = static_cast<int>(rest < vpt ? (rest > 0 ? rest : 0) : vpt);

  // the lane's run: rows that start and end inside it are written here; the
  // first row's partial (head) and the last row's (tail) go to the scan
  int first = -1, cur = -1;
  Acc acc = 0, head = 0;
  bool closed = false;                // the first row ended inside the run
  for (int b = 0; b < n_here; b += 4) {
    int rr[4], cc[4];
    Acc vv[4];
    if (vec && b + 4 <= n_here) {
      const int4 r4 = __ldg(reinterpret_cast<const int4*>(row + e0 + b));
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(col + e0 + b));
      rr[0] = r4.x; rr[1] = r4.y; rr[2] = r4.z; rr[3] = r4.w;
      cc[0] = c4.x; cc[1] = c4.y; cc[2] = c4.z; cc[3] = c4.w;
      load4<Store, Acc>(val + e0 + b, vv);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = b + q < n_here;
        rr[q] = in ? row[e0 + b + q] : -1;
        cc[q] = in ? col[e0 + b + q] : 0;
        vv[q] = in ? to_acc<Acc>(val[e0 + b + q]) : Acc(0);
      }
    }
    Acc p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = vv[q] * __ldg(x + cc[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (b + q >= n_here) break;
      const int r = rr[q];
      if (r != cur) {
        if (cur < 0) {
          first = r;
        } else {
          if (closed) y[cur] = acc;
          else { head = acc; closed = true; }
          zero_gap(y, cur + 1, r);
        }
        cur = r;
        acc = 0;
      }
      acc += p[q];
    }
  }

  // segmented inclusive scan of the tails over the lanes: rows are sorted,
  // so equal keys are adjacent (an empty lane's key is -1, its tail 0)
  Acc v = acc;
  for (int off = 1; off < 32; off <<= 1) {
    const Acc vo = __shfl_up_sync(kFull, v, off);
    const int ko = __shfl_up_sync(kFull, cur, off);
    if (lane >= off && ko == cur) v += vo;
  }
  const Acc v_prev = __shfl_up_sync(kFull, v, 1);
  const int k_prev = __shfl_up_sync(kFull, cur, 1);
  const int next_first = __shfl_down_sync(kFull, first, 1);
  const int chunk_first = __shfl_sync(kFull, first, 0);
  if (n_here == 0) return;

  if (w == 0 && lane == 0) zero_gap(y, 0, first);
  if (closed) {
    // the first row ends inside the run: add what the lanes before hold
    const Acc total = head + ((lane > 0 && k_prev == first) ? v_prev : Acc(0));
    if (first == chunk_first) {
      carry_row[2 * w] = first;
      carry_val[2 * w] = total;
    } else {
      y[first] = total;
    }
  }
  // the last lane with entries: lane 31, or the one before the first empty lane
  const bool last_lane = lane == 31 || next_first < 0;
  if (!last_lane) {
    if (next_first != cur) {          // the last row ends with the run
      if (cur == chunk_first) {
        carry_row[2 * w] = cur;
        carry_val[2 * w] = v;
      } else {
        y[cur] = v;
      }
      zero_gap(y, cur + 1, next_first);
    }
    return;
  }
  const int after = end < nnz ? row[end] : m;   // the next chunk's first row
  if (cur == chunk_first) {
    carry_row[2 * w] = cur;
    carry_val[2 * w] = v;
    carry_row[2 * w + 1] = -1;
  } else if (after == cur) {          // runs on into the next chunk
    carry_row[2 * w + 1] = cur;
    carry_val[2 * w + 1] = v;
  } else {
    y[cur] = v;
    carry_row[2 * w + 1] = -1;
  }
  if (after != cur) zero_gap(y, cur + 1, after);
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
           const void* x, void* y, int m, void* carry_row, void* carry_val,
           int vpt, int block, void* stream) {
  if (vpt < 1 || block % 32 != 0 || block < 32 || block > 1024 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nnz <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nchunks = (nnz + 32LL * vpt - 1) / (32LL * vpt);
  const long long blocks = (32 * nchunks + block - 1) / block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads where every lane's run starts on four aligned entries
  const bool vec = vpt % 4 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(col) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % (4 * sizeof(Store)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  coo_chunk_kernel<Store, Acc><<<static_cast<unsigned>(blocks), block, 0, s>>>(
      static_cast<const int*>(row), static_cast<const int*>(col),
      static_cast<const Store*>(val), nnz, vpt, nchunks, vec,
      static_cast<const Acc*>(x), static_cast<Acc*>(y), m,
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
                      long long nnz, const void* x, void* y, int m,
                      void* carry_row, void* carry_val, int vpt, int block,
                      void* stream) {
  return launch<float, float>(row, col, val, nnz, x, y, m, carry_row, carry_val,
                              vpt, block, stream);
}

int cusp_coo_spmv_bf16(const void* row, const void* col, const void* val,
                       long long nnz, const void* x, void* y, int m,
                       void* carry_row, void* carry_val, int vpt, int block,
                       void* stream) {
  return launch<__nv_bfloat16, float>(row, col, val, nnz, x, y, m, carry_row,
                                      carry_val, vpt, block, stream);
}

int cusp_coo_spmv_f64(const void* row, const void* col, const void* val,
                      long long nnz, const void* x, void* y, int m,
                      void* carry_row, void* carry_val, int vpt, int block,
                      void* stream) {
  return launch<double, double>(row, col, val, nnz, x, y, m, carry_row,
                                carry_val, vpt, block, stream);
}

}  // extern "C"
