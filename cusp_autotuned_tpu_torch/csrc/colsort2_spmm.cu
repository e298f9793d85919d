// Virtual-row CSR SpMM with a fixed-plane fold: Y[r, c] =
// sum_{e in [indptr[r], indptr[r+1])} val[e] * X[col[e], c], with X (n, k)
// and Y (m, k) row-major and contiguous.
//
// Replaces the JAX package's colsort2 Pallas kernel at its SpMM site,
// _v2_kernel (kernels/pallas_colsort2.py:519, launched at K > 0 from :883,
// the k columns of a VMEM chunk looped inside the kernel).  It walks the
// SpMV's plan (colsort2_spmv.cu): a row of at most thr entries is summed
// plane by plane (plane p: its entries [p V, (p + 1) V)), the planes
// folded in order, and rows above thr are hub rows cut into virtual rows of
// at most 128 entries, folded per row in order by a second kernel.  The
// first kernel had a team of min(32, next_pow2(k)) lanes for each (row,
// plane), every lane a 4-byte load of X per entry and every team a
// broadcast load of each entry.  Now the columns follow the DIA SpMM's
// schedule (kernels/dia.py spmm_schedule): a lane takes C columns with
// 16-byte loads and stores where k and the alignment allow, all k columns
// where k <= 4, a team of T lanes a tile of T C columns, the grid's second
// dimension the tiles past it:
//
//   * main: csrc/rail_spmm.cuh's walk, a team a row, each round the
//     warp's teams' next entries loaded together into shared memory, each
//     team walking its row's entries from there in order, one plane's sum
//     at a time, adding each plane to the row's total as it closes: the
//     plain version's order (the routed and binned SpMMs take the same walk
//     with one plane);
//   * hub: a team per (hub virtual row, column tile) loads the virtual
//     row's entries T at a time, a lane each, and walks them in order from
//     its lanes' registers by shuffles; a fold kernel adds each hub row's
//     virtual rows in order, a thread per (hub row, column) indexed by
//     shifts.
//
// Every row of Y is written (a main row by its team, a hub row by the
// fold), so Y needs no fill.  No atomics: the same result on every run.
// Bound by bytes: per entry a value and a column index, the gathered rows of
// X (through L2), Y written once.  Row and element offsets of X and Y are
// 64-bit.
#include "common.cuh"
#include "rail_spmm.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename Store, typename Acc, int W, int C>
__global__ void colsort2_spmm_main_kernel(const int* __restrict__ indptr,
                                          const int* __restrict__ col,
                                          const Store* __restrict__ val,
                                          const Acc* __restrict__ x,
                                          Acc* __restrict__ y, int m, int k,
                                          int V, int thr, int team_shift) {
  rail_spmm::walk<Store, Acc, W, C, false>(indptr, col, val, nullptr, nullptr,
                                           x, y, m, k, V, thr, team_shift);
}

// A team of T lanes per (hub virtual row, column tile): part[v, c] = sum
// over entries [lo[v], hi[v]) of val * X[col, c], in entry order.
template <typename Store, typename Acc, int W, int C>
__global__ void colsort2_spmm_hub_kernel(const int* __restrict__ col,
                                         const Store* __restrict__ val,
                                         const Acc* __restrict__ x,
                                         const int* __restrict__ lo,
                                         const int* __restrict__ hi, int nv,
                                         int k, int team_shift,
                                         Acc* __restrict__ part) {
  const int T = 1 << team_shift;
  const int tl = threadIdx.x & (T - 1);
  const long long v = static_cast<long long>(blockIdx.x) * (blockDim.x >> team_shift) +
                      (threadIdx.x >> team_shift);
  const int c0 = ((static_cast<int>(blockIdx.y) << team_shift) + tl) * C;
  // the teams of a warp stay together for the shuffles: a team past nv
  // walks an empty range
  const int b = v < nv ? __ldg(lo + v) : 0, e_end = v < nv ? __ldg(hi + v) : 0;
  const unsigned mask = T == 32 ? kFull
                                : ((1u << T) - 1) << (threadIdx.x & 31 & ~(T - 1));
  Acc acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0;
  for (int e0 = b; e0 < e_end; e0 += T) {
    const int e = e0 + tl;
    const int ce = e < e_end ? __ldg(col + e) : 0;
    const Acc ve = e < e_end ? to_acc<Acc>(val[e]) : Acc(0);
    const int n_here = min(T, e_end - e0);
    for (int j = 0; j < n_here; ++j) {
      const int cj = __shfl_sync(mask, ce, j, T);
      const Acc vj = __shfl_sync(mask, ve, j, T);
      if (c0 < k) {
        Acc xv[C];
        load_cols<Acc, W, C>(x + static_cast<long long>(cj) * k + c0, xv);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fma_rn(vj, xv[c], acc[c]);
      }
    }
  }
  if (v < nv && c0 < k) store_cols<Acc, W, C>(part + v * k + c0, acc);
}

// A thread per (hub row, column): slot blockIdx.x * (block >> col_shift) +
// threadIdx.x >> col_shift, column blockIdx.y << col_shift | the rest; its
// virtual rows in order.
template <typename Acc>
__global__ void colsort2_spmm_hub_fold_kernel(const Acc* __restrict__ part,
                                              const int* __restrict__ rows,
                                              const int* __restrict__ ptr,
                                              int nh, int k, int col_shift,
                                              Acc* __restrict__ y) {
  const long long h = static_cast<long long>(blockIdx.x) * (blockDim.x >> col_shift) +
                      (threadIdx.x >> col_shift);
  const int c = (static_cast<int>(blockIdx.y) << col_shift) +
                (threadIdx.x & ((1 << col_shift) - 1));
  if (h >= nh || c >= k) return;
  Acc total = 0;
  for (int v = ptr[h]; v < ptr[h + 1]; ++v) total += part[static_cast<long long>(v) * k + c];
  y[static_cast<long long>(rows[h]) * k + c] = total;
}

bool tiles_of(int k, int cols, int team_shift, long long* tiles) {
  if (k < 1 || cols < 1 || team_shift < 0 || team_shift > 5) return false;
  const long long span = static_cast<long long>(cols) << team_shift;
  *tiles = (k + span - 1) / span;
  return *tiles <= 65535;
}

template <typename Store, typename Acc>
int launch_main(const void* indptr, const void* col, const void* val,
                const void* x, void* y, int m, int k, int V, int thr, int width,
                int cols, int team_shift, int block, void* stream) {
  dim3 grid;
  if (V < 1 || !rail_spmm::grid_of(m, k, cols, team_shift, block, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid.x == 0) return 0;
  return with_width<Acc>(width, cols, [&](auto w, auto c) {
    colsort2_spmm_main_kernel<Store, Acc, decltype(w)::value, decltype(c)::value>
        <<<grid, block, rail_spmm::smem_bytes<Acc>(block),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(indptr), static_cast<const int*>(col),
            static_cast<const Store*>(val), static_cast<const Acc*>(x),
            static_cast<Acc*>(y), m, k, V, thr, team_shift);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename Store, typename Acc>
int launch_hub(const void* col, const void* val, const void* x, const void* lo,
               const void* hi, int nv, const void* rows, const void* ptr,
               int nh, void* part, void* y, int k, int width, int cols,
               int team_shift, int block, void* stream) {
  long long tiles;
  if (block % 32 != 0 || block < 32 || block > 1024 ||
      !tiles_of(k, cols, team_shift, &tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nv == 0 || nh == 0) return 0;
  const long long teams = block >> team_shift;
  const long long blocks = (nv + teams - 1) / teams;
  int col_shift = 0;
  while ((1 << col_shift) < k && col_shift < 5) ++col_shift;
  const long long fold_blocks =
      (nh + (block >> col_shift) - 1) / (block >> col_shift);
  const long long fold_tiles = (k + (1 << col_shift) - 1) >> col_shift;
  if (fold_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_width<Acc>(width, cols, [&](auto w, auto c) {
    colsort2_spmm_hub_kernel<Store, Acc, decltype(w)::value, decltype(c)::value>
        <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles)),
           block, 0, s>>>(
            static_cast<const int*>(col), static_cast<const Store*>(val),
            static_cast<const Acc*>(x), static_cast<const int*>(lo),
            static_cast<const int*>(hi), nv, k, team_shift,
            static_cast<Acc*>(part));
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  colsort2_spmm_hub_fold_kernel<Acc>
      <<<dim3(static_cast<unsigned>(fold_blocks), static_cast<unsigned>(fold_tiles)),
         block, 0, s>>>(
          static_cast<const Acc*>(part), static_cast<const int*>(rows),
          static_cast<const int*>(ptr), nh, k, col_shift, static_cast<Acc*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cusp_colsort2_spmm_f32(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int k, int V, int thr,
                           int width, int cols, int team_shift, int block,
                           void* stream) {
  return launch_main<float, float>(indptr, col, val, x, y, m, k, V, thr, width,
                                 cols, team_shift, block, stream);
}

int cusp_colsort2_hub_spmm_f32(const void* col, const void* val, const void* x,
                               const void* lo, const void* hi, int nv,
                               const void* rows, const void* ptr, int nh,
                               void* part, void* y, int k, int width, int cols,
                               int team_shift, int block, void* stream) {
  return launch_hub<float, float>(col, val, x, lo, hi, nv, rows, ptr, nh, part, y,
                                k, width, cols, team_shift, block, stream);
}

int cusp_colsort2_spmm_bf16(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int k, int V, int thr,
                           int width, int cols, int team_shift, int block,
                           void* stream) {
  return launch_main<__nv_bfloat16, float>(indptr, col, val, x, y, m, k, V, thr, width,
                                 cols, team_shift, block, stream);
}

int cusp_colsort2_hub_spmm_bf16(const void* col, const void* val, const void* x,
                               const void* lo, const void* hi, int nv,
                               const void* rows, const void* ptr, int nh,
                               void* part, void* y, int k, int width, int cols,
                               int team_shift, int block, void* stream) {
  return launch_hub<__nv_bfloat16, float>(col, val, x, lo, hi, nv, rows, ptr, nh, part, y,
                                k, width, cols, team_shift, block, stream);
}

int cusp_colsort2_spmm_f64(const void* indptr, const void* col, const void* val,
                           const void* x, void* y, int m, int k, int V, int thr,
                           int width, int cols, int team_shift, int block,
                           void* stream) {
  return launch_main<double, double>(indptr, col, val, x, y, m, k, V, thr, width,
                                 cols, team_shift, block, stream);
}

int cusp_colsort2_hub_spmm_f64(const void* col, const void* val, const void* x,
                               const void* lo, const void* hi, int nv,
                               const void* rows, const void* ptr, int nh,
                               void* part, void* y, int k, int width, int cols,
                               int team_shift, int block, void* stream) {
  return launch_hub<double, double>(col, val, x, lo, hi, nv, rows, ptr, nh, part, y,
                                k, width, cols, team_shift, block, stream);
}

}  // extern "C"
