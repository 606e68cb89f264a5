// SELL-C-sigma SpMV on Hopper: y[row_perm[i]] = sum_w vals[i, w] * x[cols[i, w]].
//
// Replaces the TPU kernel src/repro/kernels/sell_spmv.py::sell_spmv_pallas.
//
// Bound: device-memory bytes.  Every stored slot costs 8 bytes of cols + vals
// read once plus one gathered x element, for 2 flops: far below the card's
// operations-per-byte balance, so the kernel is written to move each byte once.
//
// Design: one warp per chunk of C = 8 sorted rows, 8 rows x 4 lanes.  Each lane
// strides its row's W slots by 4, so a row's 4 lanes read 16 consecutive bytes
// of cols and of vals per step.  x is gathered through the read-only path
// (__ldg) and stays in the 50 MB L2 at the suite's sizes.  The 4 lane partials
// reduce with two __shfl_xor_sync in a fixed order, so the result is
// deterministic.  The un-permute is fused: row_perm is a permutation of the
// valid rows (-1 marks padding), so lane 0 of each row stores straight to
// y[row_perm[i]] with no atomics and y needs no zero fill.  chunk_tile only
// sets the launch shape (chunk_tile warps per block).
#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;      // rows per chunk
constexpr int kLanes = 4;  // lanes per row

__global__ void sell_spmv_kernel(const int* __restrict__ cols,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ x,
                                 const int* __restrict__ row_perm,
                                 float* __restrict__ y, long long n_chunks,
                                 int W) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const int r = lane >> 2;
  const int q = lane & 3;
  const long long i = chunk * kC + r;
  const long long base = i * (long long)W;
  float acc = 0.f;
  for (int w = q; w < W; w += kLanes) {
    acc = fmaf(__ldg(vals + base + w), __ldg(x + __ldg(cols + base + w)), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (q == 0) {
    const int row = row_perm[i];
    if (row >= 0) y[row] = acc;
  }
}

}  // namespace

extern "C" int sell_spmv_launch(const int* cols, const float* vals,
                                const float* x, const int* row_perm, float* y,
                                long long n_chunks, int W, int chunk_tile,
                                void* stream) {
  if (n_chunks <= 0) return 0;
  if (chunk_tile < 1 || chunk_tile > 32 || W < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (n_chunks + chunk_tile - 1) / chunk_tile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sell_spmv_kernel<<<(unsigned)grid, 32 * chunk_tile, 0, (cudaStream_t)stream>>>(
      cols, vals, x, row_perm, y, n_chunks, W);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
