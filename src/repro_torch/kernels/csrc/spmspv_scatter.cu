// Scatter-add of a product stream on Hopper: y[rows[t]] += prods[t] for t < total.
//
// Replaces the TPU kernel src/repro/kernels/spmspv.py::spmspv_scatter_pallas
// (spmspv.py:212), the accumulation step of the bucket SpMSpV.
//
// Bound: device-memory bytes.  The function reads each of the T true products
// once (a 4-byte row and a 4-byte value) and writes y once: 8*T + 4*m bytes for
// one add per product, far below the card's operations-per-byte balance.
//
// Design: the TPU kernel keeps all of y in VMEM and walks its slabs in order, so
// it needs no atomics.  That does not carry over: y is 4 MB on webbase-1M, far
// beyond 227 KB of shared memory, and blocks run in no order.  So every lane adds
// its product with one atomicAdd whose result is unused, which the compiler
// lowers to a reduction performed at L2, where y stays resident (50 MB).  Block b
// covers products [b*slab, (b+1)*slab) with a block-stride loop, so neighbouring
// lanes read neighbouring bytes of rows and prods; a grid-stride loop over slabs
// covers any total.  Only the true total is read: the stream's padded tail
// (row 0, value 0, up to three quarters of the work bucket) would serialise its
// atomics on y[0].  The wrapper zero-fills y before the launch and launches
// nothing when total is 0.
//
// Determinism: the atomics land in an order that changes from run to run, so
// each row's sum is taken in another order every run.  Results agree with the
// plain version within float32 rounding of a reordered sum, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

__global__ void spmspv_scatter_kernel(const int* __restrict__ rows,
                                      const float* __restrict__ prods,
                                      float* __restrict__ y, long long total,
                                      int slab) {
  const long long step = (long long)gridDim.x * slab;
  for (long long base = (long long)blockIdx.x * slab; base < total; base += step) {
    const long long end = base + slab < total ? base + slab : total;
    for (long long t = base + threadIdx.x; t < end; t += kThreads) {
      atomicAdd(y + __ldg(rows + t), __ldg(prods + t));
    }
  }
}

}  // namespace

extern "C" int spmspv_scatter_launch(const int* rows, const float* prods,
                                     float* y, long long total, int slab,
                                     void* stream) {
  if (total <= 0) return 0;
  if (slab < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (total + slab - 1) / slab;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  spmspv_scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, prods, y, total, slab);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
