// Column-slab SELL SpMV on Hopper: the slabs share one row permutation, so
// y[row_perm[i]] = sum_s sum_{w < chunk_w[s, chunk(i)]} vals[s, i, w] *
//                  x[s * slab_n + cols[s, i, w]].
//
// Replaces the TPU kernel src/repro/kernels/sell_spmv.py::sell_spmv_blocked_pallas.
//
// Bound: device-memory bytes (the cols + vals slots each chunk holds, x and
// y once; 2 flops per slot) and, below that, latency: every slot is a
// gather into x that depends on the load of its column.
//
// Design: each warp takes one chunk of 8 rows x 4 lanes; the slab loop is the
// inner loop, so a row's sum stays in registers across all slabs and never
// leaves the chip.  All slabs share one padded width W, but a chunk of one
// slab holds far fewer slots: the loop stops at chunk_w[s, chunk] (the
// chunk's last stored slot, rounded up to 4), so no padded slot is loaded.
// A width is rounded up to a multiple of 4 and clamped to [0, W], as the
// plain version's mask does, so none reads past its row.
// A lane loads 16 bytes of cols and of vals at a time (a row's slots start
// on 16-byte boundaries, since W is a multiple of 4) and two such groups per
// step, so up to 8 gathers are in flight; two accumulators, added in a
// fixed order at the end, break the FMA chain.  The 4 lanes of a row meet
// in a fixed shuffle, and the total goes straight to y[row_perm[i]] (the
// un-permute is fused, as in sell_spmv.cu): no atomics, deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void slot4(float& acc0, float& acc1, const float* xs,
                                      int4 c, float4 v) {
  acc0 = fmaf(v.x, __ldg(xs + c.x), acc0);
  acc1 = fmaf(v.y, __ldg(xs + c.y), acc1);
  acc0 = fmaf(v.z, __ldg(xs + c.z), acc0);
  acc1 = fmaf(v.w, __ldg(xs + c.w), acc1);
}

__global__ void __launch_bounds__(kThreads)
sell_spmv_blocked_kernel(const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const int* __restrict__ chunk_w,
                         const float* __restrict__ x,
                         const int* __restrict__ row_perm,
                         float* __restrict__ y, int n_slabs,
                         long long n_chunks, int W, long long slab_n) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const int q = lane & 3;
  const long long i = chunk * kC + (lane >> 2);
  const long long slab_elems = n_chunks * kC * (long long)W;
  float acc0 = 0.f, acc1 = 0.f;
  int cw = __ldg(chunk_w + chunk);
  for (int s = 0; s < n_slabs; ++s) {
    const int cw_next =
        s + 1 < n_slabs ? __ldg(chunk_w + (long long)(s + 1) * n_chunks + chunk) : 0;
    const long long base = s * slab_elems + i * (long long)W;
    const int4* c4 = reinterpret_cast<const int4*>(cols + base);
    const float4* v4 = reinterpret_cast<const float4*>(vals + base);
    const float* xs = x + (long long)s * slab_n;
    const int ng = min(max(cw, 0) + 3, W) >> 2;  // groups of 4; lane q takes q, q + 4, ...
    int g = q;
    for (; g + 4 < ng; g += 8) {
      const int4 ca = __ldcs(c4 + g), cb = __ldcs(c4 + g + 4);
      const float4 va = __ldcs(v4 + g), vb = __ldcs(v4 + g + 4);
      slot4(acc0, acc1, xs, ca, va);
      slot4(acc0, acc1, xs, cb, vb);
    }
    if (g < ng) slot4(acc0, acc1, xs, __ldcs(c4 + g), __ldcs(v4 + g));
    cw = cw_next;
  }
  float acc = acc0 + acc1;
  acc += __shfl_xor_sync(kFull, acc, 1);
  acc += __shfl_xor_sync(kFull, acc, 2);
  if (q == 0) {
    const int row = row_perm[i];
    if (row >= 0) y[row] = acc;
  }
}

}  // namespace

extern "C" int sell_spmv_blocked_launch(const int* cols, const float* vals,
                                        const int* chunk_w, const float* x,
                                        const int* row_perm, float* y,
                                        int n_slabs, long long n_chunks, int W,
                                        long long slab_n, void* stream) {
  if (n_chunks <= 0 || n_slabs <= 0) return 0;
  if (W < 4 || W % 4 != 0 || slab_n < 1) return (int)cudaErrorInvalidValue;
  const long long warps = kThreads / 32;
  const long long grid = (n_chunks + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sell_spmv_blocked_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      cols, vals, chunk_w, x, row_perm, y, n_slabs, n_chunks, W, slab_n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
