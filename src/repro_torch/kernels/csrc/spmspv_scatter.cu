// Fused SpMSpV on Hopper: y = A @ x for a sparse x, expansion and scatter in
// one kernel.  For every true product t < total of the touched columns:
//   slot(t) = the last x slot with offs[slot] <= t,
//   src     = col_start[xi[slot]] + t - offs[slot],
//   y[rows[src]] += vals[src] * xv[slot].
//
// Replaces the TPU kernel src/repro/kernels/spmspv.py::spmspv_scatter_pallas
// (spmspv.py:212) together with the jnp expansion that feeds it inside one jit
// (expand_products, spmspv.py:178; spmspv_pallas_fn, spmspv.py:246).
//
// Bound: device-memory bytes.  The function reads each of the T true products
// once from the CSC streams (a 4-byte row and a 4-byte value), four 4-byte
// words per x slot (xi, xv, offs and the gathered col_start), and writes y once:
// 8*T + 16*B + 4*m bytes for one multiply and one add per product, far below
// the card's operations-per-byte balance.  At serving sizes (T of 10^4-10^6)
// the kernel is latency-bound: a product is a chain of dependent loads.
//
// Design.  The expansion used to run as about ten eager torch launches that
// wrote a (rows, products) stream of the padded work bucket to device memory
// for a scatter kernel to read back.  Here nothing of the stream leaves the
// chip.  The work is split by product, not by column: block b takes products
// [b*tile, (b+1)*tile), so neighbouring lanes read neighbouring rows/vals of
// one CSC column, and a hub column (92 853 entries on webbase-1M) spreads over
// many blocks.  The host, which already gathers the touched column lengths to
// find T, passes the cumulative offsets offs (B + 1) and each block's first
// slot first[b] = slot(b*tile) (first[n_blocks] = slot(T - 1)), and sizes the
// tile to the card: 128 threads a block, 1 to 4 products a thread, so that
// T = 21 293 gives 167 blocks on 132 SMs.  A block stages its slots' offsets,
// col_start[xi[s]] - offs[s] and xv[s] in shared memory (one coalesced pass,
// up to kStage slots) and each product finds its slot by a binary search
// there.  A block's run of products can cross any number of empty columns
// (offs repeats), so a run of more than kStage slots is searched in device
// memory instead, between the same two host-given bounds.  A thread loads
// all its products' rows and values before its first atomic, so up to four
// load pairs are in flight.  Each product is added with one atomicAdd whose
// result is unused, which lowers to a reduction at L2, where y (4 MB on
// webbase-1M) stays; rows/vals are streamed with evict-first loads.  Only the
// true products are touched: the work bucket G and its padded tail belong to
// the plain version.  The wrapper zero-fills y and launches nothing when T is 0.
//
// Determinism: the atomics land in an order that changes from run to run, so
// each row's sum is taken in another order every run.  Results agree with the
// plain version within float32 rounding of a reordered sum, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPer = 4;     // products a thread takes: tile <= 512
constexpr int kStage = 1024;   // slots a block stages in shared memory

__global__ void __launch_bounds__(kThreads)
spmspv_scatter_kernel(const int* __restrict__ col_start,
                      const int* __restrict__ rows,
                      const float* __restrict__ vals,
                      const int* __restrict__ xi, const float* __restrict__ xv,
                      const int* __restrict__ offs,
                      const int* __restrict__ first, float* __restrict__ y,
                      int total, int tile) {
  __shared__ int s_offs[kStage];
  __shared__ int s_base[kStage];  // col_start[xi[s]] - offs[s]
  __shared__ float s_xv[kStage];
  const int t0 = blockIdx.x * tile;  // < total < 2^31
  const int count = min(total - t0, tile);  // products of this block
  const int lo = __ldg(first + blockIdx.x);
  const int span = __ldg(first + blockIdx.x + 1) - lo + 1;  // slots lo .. hi
  const bool staged = span <= kStage;  // the same for the whole block
  if (staged) {
    for (int i = threadIdx.x; i < span; i += kThreads) {
      const int o = __ldg(offs + lo + i);
      s_offs[i] = o;
      s_base[i] = __ldg(col_start + __ldg(xi + lo + i)) - o;
      s_xv[i] = __ldg(xv + lo + i);
    }
    __syncthreads();
  }
  int src[kMaxPer];
  float scale[kMaxPer];
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    const int t = t0 + k;
    src[j] = -1;
    if (k < count) {
      // the last slot in [0, span) whose offset is <= t; slot 0 always is
      int a = 0, b = span - 1;
      if (staged) {
        while (a < b) {
          const int mid = (a + b + 1) >> 1;
          if (s_offs[mid] <= t) a = mid; else b = mid - 1;
        }
        src[j] = s_base[a] + t;
        scale[j] = s_xv[a];
      } else {
        while (a < b) {
          const int mid = (a + b + 1) >> 1;
          if (__ldg(offs + lo + mid) <= t) a = mid; else b = mid - 1;
        }
        const int s = lo + a;
        src[j] = __ldg(col_start + __ldg(xi + s)) + t - __ldg(offs + s);
        scale[j] = __ldg(xv + s);
      }
    }
  }
  int r[kMaxPer];
  float p[kMaxPer];
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (src[j] >= 0) {
      r[j] = __ldcs(rows + src[j]);
      p[j] = __ldcs(vals + src[j]) * scale[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (src[j] >= 0) atomicAdd(y + r[j], p[j]);
  }
}

}  // namespace

extern "C" int spmspv_scatter_launch(const int* col_start, const int* rows,
                                     const float* vals, const int* xi,
                                     const float* xv, const int* offs,
                                     const int* first, float* y, int total,
                                     int tile, int n_blocks, void* stream) {
  if (total <= 0) return 0;
  if (tile < 1 || tile > kThreads * kMaxPer ||
      (long long)n_blocks * tile < total ||
      (long long)(n_blocks - 1) * tile >= total) {
    return (int)cudaErrorInvalidValue;
  }
  spmspv_scatter_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      col_start, rows, vals, xi, xv, offs, first, y, total, tile);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
