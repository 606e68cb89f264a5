// Column-slab SELL SpMV on Hopper: the slabs share one row permutation, so
// y[row_perm[i]] = sum_s sum_w vals[s, i, w] * x[s * slab_n + cols[s, i, w]].
//
// Replaces the TPU kernel src/repro/kernels/sell_spmv.py::sell_spmv_blocked_pallas.
//
// Bound: device-memory bytes (cols + vals of every slab read once, x and y
// once; 2 flops per slot).
//
// Design: each warp takes one chunk of 8 rows x 4 lanes at a time, as in
// sell_spmv.cu, and no row's sum ever leaves the chip.  Two paths, chosen by
// the wrapper (stage = 1 when an x slab fits in shared memory):
//
// * global x (stage = 0): the slab loop is the inner loop of each chunk.  A
//   lane's running sum stays in a register across all slabs, x is gathered
//   from global memory through the read-only path, and the 4 lanes reduce once
//   at the end.
// * staged x (stage = 1): the TPU's sequential slab grid becomes the outer
//   loop of a persistent block that owns a contiguous range of chunks.  Per
//   slab the block copies the x slab to shared memory, so the gather hits
//   shared memory and each block reads x once per slab.  The running sums of
//   the block's rows sit in shared memory beside the slab, each written and
//   re-read by the same lane in slab order 0, 1, ...
//
// Either way: no atomics, a fixed summation order (deterministic), and the
// total goes straight to y[row_perm[i]] (the un-permute is fused, as in
// sell_spmv.cu).
#include <cuda_runtime.h>

namespace {

constexpr int kC = 8;
constexpr int kLanes = 4;
constexpr int kGlobalThreads = 256;
constexpr int kStageThreads = 1024;

__global__ void __launch_bounds__(kGlobalThreads)
sell_spmv_blocked_global(const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const float* __restrict__ x,
                         const int* __restrict__ row_perm,
                         float* __restrict__ y, int n_slabs,
                         long long n_chunks, int W, long long slab_n) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const int r = lane >> 2;
  const int q = lane & 3;
  const long long i = chunk * kC + r;
  const long long slab_elems = n_chunks * kC * (long long)W;
  float acc = 0.f;
  for (int s = 0; s < n_slabs; ++s) {
    const long long base = s * slab_elems + i * (long long)W;
    const float* xs = x + (long long)s * slab_n;
    for (int w = q; w < W; w += kLanes) {
      acc = fmaf(__ldg(vals + base + w), __ldg(xs + __ldg(cols + base + w)), acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (q == 0) {
    const int row = row_perm[i];
    if (row >= 0) y[row] = acc;
  }
}

__global__ void __launch_bounds__(kStageThreads)
sell_spmv_blocked_staged(const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const float* __restrict__ x,
                         const int* __restrict__ row_perm,
                         float* __restrict__ y, int n_slabs,
                         long long n_chunks, int W, long long slab_n,
                         long long chunks_per_block) {
  extern __shared__ float smem[];
  float* xs = smem;            // slab_n floats: the current x slab
  float* sums = smem + slab_n;  // chunks_per_block * 8 running row sums
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2;
  const int q = lane & 3;
  const long long c0 = (long long)blockIdx.x * chunks_per_block;
  const long long c1 = min(c0 + chunks_per_block, n_chunks);
  const long long slab_elems = n_chunks * kC * (long long)W;
  for (int s = 0; s < n_slabs; ++s) {
    const float* xsrc = x + (long long)s * slab_n;
    __syncthreads();  // every warp is done with the previous slab
    for (long long t = threadIdx.x; t < slab_n; t += blockDim.x) xs[t] = xsrc[t];
    __syncthreads();
    const int* cs = cols + (long long)s * slab_elems;
    const float* vs = vals + (long long)s * slab_elems;
    for (long long chunk = c0 + warp; chunk < c1; chunk += warps) {
      const long long i = chunk * kC + r;
      const long long base = i * (long long)W;
      float acc = 0.f;
      for (int w = q; w < W; w += kLanes) {
        acc = fmaf(__ldg(vs + base + w), xs[__ldg(cs + base + w)], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) {
        const long long local = (chunk - c0) * kC + r;
        const float tot = (s == 0) ? acc : sums[local] + acc;
        if (s + 1 < n_slabs) {
          sums[local] = tot;
        } else {
          const int row = row_perm[i];
          if (row >= 0) y[row] = tot;
        }
      }
    }
  }
}

int launch_global(const int* cols, const float* vals, const float* x,
                  const int* row_perm, float* y, int n_slabs, long long n_chunks,
                  int W, long long slab_n, cudaStream_t stream) {
  const long long warps = kGlobalThreads / 32;
  const long long grid = (n_chunks + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sell_spmv_blocked_global<<<(unsigned)grid, kGlobalThreads, 0, stream>>>(
      cols, vals, x, row_perm, y, n_slabs, n_chunks, W, slab_n);
  return (int)cudaGetLastError();
}

int launch_staged(const int* cols, const float* vals, const float* x,
                  const int* row_perm, float* y, int n_slabs, long long n_chunks,
                  int W, long long slab_n, cudaStream_t stream) {
  auto kernel = sell_spmv_blocked_staged;
  const long long warps = kStageThreads / 32;
  const long long chunk_bytes = kC * sizeof(float);
  const long long x_bytes = slab_n * (long long)sizeof(float);
  int device = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  // The slab plus one chunk of row sums per warp must fit, or the wrapper
  // should have chosen the global path.
  if (x_bytes + warps * chunk_bytes > limit) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kStageThreads, (size_t)(x_bytes + warps * chunk_bytes));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // As many blocks as fit on the SMs at once, unless their row sums would
  // not fit beside the slab: then more blocks, each owning fewer chunks.
  long long grid = (n_chunks + warps - 1) / warps;
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  long long per_block = (n_chunks + grid - 1) / grid;
  const long long max_per_block = (limit - x_bytes) / chunk_bytes;
  if (per_block > max_per_block) per_block = max_per_block;
  grid = (n_chunks + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(x_bytes + per_block * chunk_bytes);
  kernel<<<(unsigned)grid, kStageThreads, smem, stream>>>(
      cols, vals, x, row_perm, y, n_slabs, n_chunks, W, slab_n, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sell_spmv_blocked_launch(const int* cols, const float* vals,
                                        const float* x, const int* row_perm,
                                        float* y, int n_slabs,
                                        long long n_chunks, int W,
                                        long long slab_n, int stage,
                                        void* stream) {
  if (n_chunks <= 0 || n_slabs <= 0) return 0;
  if (W < 1 || slab_n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stage) {
    return launch_staged(cols, vals, x, row_perm, y, n_slabs, n_chunks, W, slab_n, s);
  }
  return launch_global(cols, vals, x, row_perm, y, n_slabs, n_chunks, W, slab_n, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
