// Take probe: for each tile g, row r, column c and pass p = 0..passes-1,
//
//   ix  = idx[(p * 128 + r) * 128 + c]
//   g_p = x[(g * 128 + r) * 128 + ix] * (1 + 0.001 p)
//   acc = (ix % 2 == p % 2) ? g_p + acc : acc
//
// and out[(g * 128 + r) * 128 + c] = acc.  Every pass reads the ORIGINAL x
// row through its own index plane: the takes are independent, not a chain.
//
// Replaces the JAX package's Pallas calibration probe, the inner `kernel`
// of _take_probe_build (autotune/calibrate.py:144, launched at :158), which
// prices one (128, 128)-tile take + masked select on the TPU's vector unit.
// On Hopper the question it answers for the cost model is what one gathered
// element costs when x sits in shared memory (the x windows that the routed
// rail stages) and when it is read through L1/L2 straight from device memory
// (every other rail's gathers).  So one source holds two instantiations that
// compute the same function: kFromShared = true stages the block's x rows in
// shared memory first, as the TPU kernel's VMEM-resident tile; false reads x
// with __ldg.
//
// A block covers kRows rows of one tile, a thread each (row, column):
// 8 x 128 = 1024 threads and 4 KB of shared memory, so no opt-in above 48 KB
// is needed.  The planes (18 x 128 x 128 int32, 1.2 MB) are read coalesced
// and stay in L2 after the first tiles.  Bound: x read once, out written
// once and the planes read once over the memory rate, and passes x 16384
// gathers a tile over the SMs' shared-memory (or L1) rate; the two-point
// time at 2 and 18 passes removes the streamed part.  `passes` is a runtime
// argument, so one binary serves both points.  Products and sums are taken
// with __fmul_rn/__fadd_rn in pass order, so no multiply-add is fused and the
// plain version (torch.gather per pass) matches it bit for bit.
#include "common.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kRows = 8;

template <bool kFromShared>
__global__ void take_probe_kernel(const float* __restrict__ x,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, long long rows,
                                  int passes) {
  __shared__ float xs[kRows][kLane];
  const int c = threadIdx.x;
  const int ry = threadIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + ry;
  const bool live = row < rows;
  const float* xrow = x + row * kLane;
  if (kFromShared) {
    xs[ry][c] = live ? xrow[c] : 0.0f;
    __syncthreads();
  }
  if (!live) return;
  const int r = static_cast<int>(row % kLane);
  float acc = 0.0f;
  for (int p = 0; p < passes; ++p) {
    const int ix = __ldg(idx + (static_cast<long long>(p) * kLane + r) * kLane + c);
    const float v = kFromShared ? xs[ry][ix] : __ldg(xrow + ix);
    const float g = __fmul_rn(v, static_cast<float>(1.0 + 0.001 * p));
    if ((ix & 1) == (p & 1)) acc = __fadd_rn(g, acc);
  }
  out[row * kLane + c] = acc;
}

}  // namespace

// x: (rows, 128) f32, rows a multiple of 128 (G tiles); idx: at least
// passes x 128 rows of 128 int32 column indices in [0, 128); out like x.
extern "C" int cusp_take_probe_f32(const void* x, const void* idx, void* out,
                                   long long rows, int passes, int from_shared,
                                   void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kLane, kRows);
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (from_shared)
    take_probe_kernel<true><<<static_cast<unsigned>(blocks), block, 0, s>>>(
        xf, ix, o, rows, passes);
  else
    take_probe_kernel<false><<<static_cast<unsigned>(blocks), block, 0, s>>>(
        xf, ix, o, rows, passes);
  return static_cast<int>(cudaGetLastError());
}
