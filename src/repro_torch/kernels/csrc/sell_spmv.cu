// SELL-C-sigma SpMV on Hopper: y[row_perm[i]] = sum_w vals[i, w] * x[cols[i, w]].
//
// Replaces the TPU kernel src/repro/kernels/sell_spmv.py::sell_spmv_pallas.
//
// Bound: device-memory bytes.  Every stored slot costs 8 bytes of cols + vals
// read once plus one gathered x element, for 2 flops: far below the card's
// operations-per-byte balance, so the kernel is written to move as few bytes as
// the format allows.
//
// Layout: cols and vals are stored slot-major inside each chunk, (n_chunks, W,
// C = 8) in memory, so one slot of a chunk (8 rows x 4 bytes) is one 32-byte
// sector.  The prepare (ops.from_arrays) hands the kernel's callers the
// logical (n_chunks, 8, W) view of that storage.  Every chunk holds slots only
// up to its own width chunk_w[chunk] (its last stored slot + 1, derived from the
// arrays); past it lies the padding to the one global width W.  Row-major rows
// of W = 32 slots are four sectors each, so a row-major kernel moves all of
// them whatever it skips; slot-major, a chunk read to its width moves chunk_w
// sectors of each array and nothing more (ldoor: about 190 of 244 MB).
//
// Design: one warp per chunk.  Lane l takes row l mod 8 and slots l div 8,
// +4, +8, ... below chunk_w, so each load instruction of the warp covers four
// slots x 8 rows = 128 contiguous bytes of cols and of vals.  Lanes keep two
// such steps in flight (two accumulators, summed in a fixed order), cols/vals
// are read with evict-first streaming loads so that x keeps its place in the
// 50 MB L2, and x is gathered through the read-only path.  The four partials
// of a row (lanes l, l+8, l+16, l+24) meet in two fixed shuffles, so the
// result is deterministic, and lane l < 8 stores straight to y[row_perm[i]]:
// row_perm is a permutation of the valid rows (-1 marks padding), so the
// fused un-permute needs no atomics and y no zero fill.  A width is clamped to
// [0, W].  chunk_tile only sets the launch shape (chunk_tile warps per
// block).  Kept over 16-byte loads of 4 rows of one slot: those move the same
// sectors but sum each row over 16 lanes (four times the shuffles).
#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;  // rows per chunk = lanes per slot
constexpr unsigned kFull = 0xffffffffu;

__global__ void sell_spmv_kernel(const int* __restrict__ cols,
                                 const float* __restrict__ vals,
                                 const int* __restrict__ chunk_w,
                                 const float* __restrict__ x,
                                 const int* __restrict__ row_perm,
                                 float* __restrict__ y, long long n_chunks,
                                 int W) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const int r = lane & (kC - 1);
  const int q = lane >> 3;  // 0..3: this lane's first slot
  const int row = q == 0 ? __ldg(row_perm + chunk * kC + r) : -1;
  const int cw = min(max(__ldg(chunk_w + chunk), 0), W);
  const long long base = chunk * kC * (long long)W + r;  // (chunk, slot 0, r)
  const int* c = cols + base;
  const float* v = vals + base;
  float acc0 = 0.f, acc1 = 0.f;
  int w = q;
  for (; w + 4 < cw; w += 8) {
    const int ca = __ldcs(c + w * kC), cb = __ldcs(c + (w + 4) * kC);
    const float va = __ldcs(v + w * kC), vb = __ldcs(v + (w + 4) * kC);
    acc0 = fmaf(va, __ldg(x + ca), acc0);
    acc1 = fmaf(vb, __ldg(x + cb), acc1);
  }
  if (w < cw) acc0 = fmaf(__ldcs(v + w * kC), __ldg(x + __ldcs(c + w * kC)), acc0);
  float acc = acc0 + acc1;
  acc += __shfl_xor_sync(kFull, acc, 8);
  acc += __shfl_xor_sync(kFull, acc, 16);
  if (row >= 0) y[row] = acc;
}

}  // namespace

extern "C" int sell_spmv_launch(const int* cols, const float* vals,
                                const int* chunk_w, const float* x,
                                const int* row_perm, float* y,
                                long long n_chunks, int W, int chunk_tile,
                                void* stream) {
  if (n_chunks <= 0) return 0;
  if (chunk_tile < 1 || chunk_tile > 32 || W < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (n_chunks + chunk_tile - 1) / chunk_tile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sell_spmv_kernel<<<(unsigned)grid, 32 * chunk_tile, 0, (cudaStream_t)stream>>>(
      cols, vals, chunk_w, x, row_perm, y, n_chunks, W);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
