// Deterministic SpMSpV on Hopper: y = A @ x for a sparse x, where every y_i is
// the left-to-right float32 sum of row i's products in stream order.  Number
// the true products of the touched columns t = 0 .. total - 1:
//   slot(t) = the last x slot with offs[slot] <= t,
//   src     = col_start[xi[slot]] + t - offs[slot],
//   p_t     = fl(vals[src] * xv[slot]),  row(t) = rows[src],
//   y_i     = (((+0.0 + p_t1) + p_t2) + ...) over row i's t1 < t2 < ...
// Rows with no product are +0.0.  This is the function the TPU kernel computes.
//
// Replaces the TPU kernel src/repro/kernels/spmspv.py::spmspv_scatter_pallas
// (spmspv.py:212) together with the jnp expansion that feeds it inside one jit
// (expand_products, spmspv.py:178; spmspv_pallas_fn, spmspv.py:246).  That
// kernel walks its slabs one after another into one accumulator, so each row
// is summed in stream order: ascending x slot, and CSC order within a column.
//
// Bound: device-memory bytes.  The function reads each of the T true products
// once from the CSC streams (a 4-byte row and a 4-byte value), four 4-byte
// words per x slot (xi, xv, offs and the gathered col_start), and writes y once:
// 8*T + 16*B + 4*m bytes for one multiply and one add per product, far below
// the card's operations-per-byte balance.  At serving sizes (T of 10^4-10^6)
// the passes are latency-bound: a product is a chain of dependent loads.
//
// Design: a stable bucket sort of the products by row tile (Azad-Buluc
// buckets), then one sequential walk per tile.  Rows are cut into n_tiles
// (at most 1024) tiles of R = 2^shift rows; the products into blocks of `tile`
// (one warp each, at most 32 products a lane), block b taking [b*tile,
// (b+1)*tile).  The host gives each block's first slot (first[b]), as
// scatter_plan says.  Four launches, no atomics on floats:
//   count  each block counts its products per row tile (integer shared-memory
//          atomics: the counts are the same every run) into counts[b][tile];
//   scan   turns the counts, tile by tile and block by block within a tile,
//          into each block's first position within its tile's bucket, and
//          each tile's total; the last of its blocks to finish (an integer
//          ticket) scans the totals into each tile's bucket start;
//   place  writes every product, with its row, into its tile's bucket.  A
//          block takes its products 32 at a time in stream order, and a lane's
//          rank among its warp's products of the same tile is the count of
//          lower lanes in its __match_any_sync group, so each bucket holds its
//          products in stream order;
//   sum    one block per tile zero-fills the tile's R rows, and one warp walks
//          the bucket 32 products at a time; for each row met in a step, the
//          lowest lane of that row's group adds the group's products one by
//          one in lane order.  The rows live in shared memory up to R = 8192
//          (then the block writes them to y) and in y itself past that, when
//          m exceeds 1024 tiles of 8192 rows.  Every row of y is written, so
//          y needs no zero fill.
// The three ways a plausible kernel breaks stream order, and what this one does:
//   contraction: the product is rounded with __fmul_rn in `place` and added
//          with __fadd_rn in `sum`, never fused into an FMA;
//   signed zeros: each row starts from +0.0 and adds its first product (as
//          index_add_ into a zero-filled y does), so a row whose only product
//          is -0.0 ends as +0.0;
//   long rows: a row's products may span any number of blocks; the bucket
//          carries them in order to one sequential sum, never as partial sums
//          added afterwards.
// Only the true products are touched (twice read from the CSC streams, once
// written to and read from the buckets), plus O(m) for y and O(n_tiles *
// n_blocks) counts; the work bucket G and its padded tail belong to the plain
// version.  A block stages its slots' offsets, col_start[xi[s]] - offs[s] and
// xv[s] in shared memory (up to kStage slots) and each product finds its slot
// by a binary search there; a block whose products cross more slots (long runs
// of empty columns) searches device memory between the same host-given bounds.
// The wrapper launches nothing when T is 0.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRounds = 32;                 // products a lane takes
constexpr int kMaxTile = kWarp * kMaxRounds;   // products a block: 1024
constexpr int kStage = 1024;                   // slots a block stages
constexpr int kMaxTiles = 1024;                // row tiles
constexpr int kSmemTileShift = 13;             // rows a tile sums in shared memory
constexpr int kMaxTileShift = 30;              // rows a tile: R * 1024 >= any int m
constexpr int kScanThreads = 1024;             // 32 tiles x 32 block ranges
constexpr int kSumThreads = 128;
constexpr int kSumBatch = 8;                   // bucket steps loaded together
constexpr unsigned kFull = 0xffffffffu;

// Block b's slots lo .. lo + span - 1 into shared memory (when staged).
template <bool kScale>
__device__ __forceinline__ void stage_slots(const int* __restrict__ col_start,
                                            const int* __restrict__ xi,
                                            const float* __restrict__ xv,
                                            const int* __restrict__ offs, int lo,
                                            int span, int* s_offs, int* s_base,
                                            float* s_xv) {
  for (int i = threadIdx.x; i < span; i += kWarp) {
    const int o = __ldg(offs + lo + i);
    s_offs[i] = o;
    s_base[i] = __ldg(col_start + __ldg(xi + lo + i)) - o;
    if (kScale) s_xv[i] = __ldg(xv + lo + i);
  }
}

// The last slot in [0, span) (relative to lo) whose offset is <= t; slot 0
// always is.
__device__ __forceinline__ int find_slot(int t, int lo, int span, bool staged,
                                         const int* s_offs,
                                         const int* __restrict__ offs) {
  int a = 0, b = span - 1;
  if (staged) {
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (s_offs[mid] <= t) a = mid; else b = mid - 1;
    }
  } else {
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (__ldg(offs + lo + mid) <= t) a = mid; else b = mid - 1;
    }
  }
  return a;
}

__global__ void __launch_bounds__(kWarp)
spmspv_scatter_count(const int* __restrict__ col_start,
                     const int* __restrict__ rows, const int* __restrict__ xi,
                     const int* __restrict__ offs, const int* __restrict__ first,
                     int* __restrict__ counts, int* __restrict__ ticket, int total,
                     int tile, int shift, int n_tiles) {
  __shared__ int s_offs[kStage];
  __shared__ int s_base[kStage];
  __shared__ int hist[kMaxTiles];
  const int lane = threadIdx.x;
  const int t0 = blockIdx.x * tile;  // < total < 2^31
  const int count = min(total - t0, tile);
  const int lo = __ldg(first + blockIdx.x);
  const int span = __ldg(first + blockIdx.x + 1) - lo + 1;
  const bool staged = span <= kStage;  // the same for the whole block
  for (int k = lane; k < n_tiles; k += kWarp) hist[k] = 0;
  if (blockIdx.x == 0 && lane == 0) *ticket = 0;  // the scan pass's, read after this pass
  if (staged) stage_slots<false>(col_start, xi, nullptr, offs, lo, span, s_offs, s_base, nullptr);
  __syncwarp();
  int r[kMaxRounds];
#pragma unroll
  for (int j = 0; j < kMaxRounds; ++j) {  // every load in flight before a use
    const int i = j * kWarp + lane;
    if (i < count) {
      const int t = t0 + i;
      const int a = find_slot(t, lo, span, staged, s_offs, offs);
      const int src = staged ? s_base[a] + t
                             : __ldg(col_start + __ldg(xi + lo + a)) + t - __ldg(offs + lo + a);
      r[j] = __ldg(rows + src);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxRounds; ++j) {
    if (j * kWarp + lane < count) atomicAdd(&hist[r[j] >> shift], 1);
  }
  __syncwarp();
  int* out = counts + (size_t)blockIdx.x * n_tiles;
  for (int k = lane; k < n_tiles; k += kWarp) out[k] = hist[k];
}

// counts[b][k] -> the position of block b's first product within tile k's
// bucket (blocks in order), in place; tot[k] = tile k's products.  Lane =
// tile, warp = a range of blocks.  The last block to finish then writes
// tile_start, the exclusive scan of tot (n_tiles <= kScanThreads: one tile a
// thread), with tile_start[n_tiles] = total.
__global__ void __launch_bounds__(kScanThreads)
spmspv_scatter_scan(int* __restrict__ counts, int* __restrict__ tot,
                    int* __restrict__ ticket, int* __restrict__ tile_start,
                    int n_blocks, int n_tiles) {
  __shared__ int part[kWarp][kWarp + 1];
  __shared__ bool last;
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int k = blockIdx.x * kWarp + lane;
  const int per = (n_blocks + kWarp - 1) / kWarp;
  const int c0 = min(w * per, n_blocks), c1 = min(c0 + per, n_blocks);
  int s = 0;
  if (k < n_tiles) {
    for (int c = c0; c < c1; ++c) s += counts[(size_t)c * n_tiles + k];
  }
  part[w][lane] = s;
  __syncthreads();
  int run = 0;
  for (int v = 0; v < w; ++v) run += part[v][lane];
  if (k < n_tiles) {
    if (w == kWarp - 1) tot[k] = run + s;
    for (int c = c0; c < c1; ++c) {
      const size_t i = (size_t)c * n_tiles + k;
      const int v = counts[i];
      counts[i] = run;
      run += v;
    }
  }
  __threadfence();  // tot visible to every block before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int v = threadIdx.x < n_tiles ? __ldcg(tot + threadIdx.x) : 0;
  int x = v;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  if (lane == kWarp - 1) part[0][w] = x;  // each warp's total
  __syncthreads();
  if (w == 0) {
    int y = part[0][lane];
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(kFull, y, d);
      if (lane >= d) y += up;
    }
    part[1][lane] = y;
  }
  __syncthreads();
  x += w > 0 ? part[1][w - 1] : 0;  // inclusive over the tiles
  if (threadIdx.x < n_tiles) tile_start[threadIdx.x] = x - v;
  if (threadIdx.x == n_tiles - 1) tile_start[n_tiles] = x;  // == total
}

__global__ void __launch_bounds__(kWarp)
spmspv_scatter_place(const int* __restrict__ col_start,
                     const int* __restrict__ rows, const float* __restrict__ vals,
                     const int* __restrict__ xi, const float* __restrict__ xv,
                     const int* __restrict__ offs, const int* __restrict__ first,
                     const int* __restrict__ counts,
                     const int* __restrict__ tile_start, int* __restrict__ b_rows,
                     float* __restrict__ b_prods, int total, int tile, int shift,
                     int n_tiles) {
  __shared__ int s_offs[kStage];
  __shared__ int s_base[kStage];
  __shared__ float s_xv[kStage];
  __shared__ int base[kMaxTiles];  // where this block's next product of tile k goes
  const int lane = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int count = min(total - t0, tile);
  const int lo = __ldg(first + blockIdx.x);
  const int span = __ldg(first + blockIdx.x + 1) - lo + 1;
  const bool staged = span <= kStage;
  const int* rel = counts + (size_t)blockIdx.x * n_tiles;
  for (int k = lane; k < n_tiles; k += kWarp) {
    base[k] = __ldg(tile_start + k) + __ldg(rel + k);
  }
  if (staged) stage_slots<true>(col_start, xi, xv, offs, lo, span, s_offs, s_base, s_xv);
  __syncwarp();
  int r[kMaxRounds];
  float p[kMaxRounds];
#pragma unroll
  for (int j = 0; j < kMaxRounds; ++j) {
    const int i = j * kWarp + lane;
    if (i < count) {
      const int t = t0 + i;
      const int a = find_slot(t, lo, span, staged, s_offs, offs);
      int src;
      float scale;
      if (staged) {
        src = s_base[a] + t;
        scale = s_xv[a];
      } else {
        const int s = lo + a;
        src = __ldg(col_start + __ldg(xi + s)) + t - __ldg(offs + s);
        scale = __ldg(xv + s);
      }
      r[j] = __ldg(rows + src);
      p[j] = __fmul_rn(__ldg(vals + src), scale);  // rounded alone: no FMA later
    }
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kMaxRounds; ++j) {
    if (j * kWarp >= count) break;  // the same for the whole warp
    const bool valid = j * kWarp + lane < count;
    const int key = valid ? (r[j] >> shift) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    if (valid) {
      const int pos = base[key] + __popc(peers & lower);  // stream order within the warp
      b_rows[pos] = r[j];
      b_prods[pos] = p[j];
    }
    __syncwarp();
    if (valid && (peers & lower) == 0) base[key] += __popc(peers);
    __syncwarp();
  }
}

// kInY: the tile's rows are summed in y itself (R past shared memory).
template <bool kInY>
__global__ void __launch_bounds__(kSumThreads)
spmspv_scatter_sum(const int* __restrict__ tile_start,
                   const int* __restrict__ b_rows,
                   const float* __restrict__ b_prods, float* __restrict__ y, int m,
                   int shift) {
  extern __shared__ float s_acc[];  // the tile's rows (unless kInY)
  __shared__ float s_p[kWarp];
  const long long r0l = (long long)blockIdx.x << shift;  // < m
  const int r0 = (int)r0l;
  const int n_rows = (int)min(1ll << shift, (long long)m - r0l);
  float* acc = kInY ? y + r0 : s_acc;
  for (int i = threadIdx.x; i < n_rows; i += kSumThreads) acc[i] = 0.0f;  // +0.0
  __syncthreads();
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    const unsigned lower = (1u << lane) - 1u;
    const int beg = tile_start[blockIdx.x], end = tile_start[blockIdx.x + 1];
    for (int i0 = beg; i0 < end; i0 += kWarp * kSumBatch) {
      int lr[kSumBatch];
      float lp[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        const int i = i0 + u * kWarp + lane;
        lr[u] = i < end ? b_rows[i] - r0 : -1;
        lp[u] = i < end ? b_prods[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (i0 + u * kWarp >= end) break;  // the same for the whole warp
        s_p[lane] = lp[u];
        const unsigned peers = __match_any_sync(kFull, lr[u]);
        __syncwarp();
        if (lr[u] >= 0 && (peers & lower) == 0) {  // the group's lowest lane
          float a = acc[lr[u]];
          for (unsigned g = peers; g; g &= g - 1u) a = __fadd_rn(a, s_p[__ffs(g) - 1]);
          acc[lr[u]] = a;
        }
        __syncwarp();
      }
    }
  }
  if (kInY) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows; i += kSumThreads) y[r0 + i] = acc[i];
}

}  // namespace

// The four passes in order on `stream`, each checked right after its launch.
// `scratch` (int32) holds, in order: counts (n_blocks x n_tiles), tot
// (n_tiles), tile_start (n_tiles + 1), the scan's ticket (1), the bucket rows
// (total) and the bucket products (total, float32).  *launched is the count
// of passes launched; a refused pass stops the sequence and returns its error.
extern "C" int spmspv_scatter_launch(const int* col_start, const int* rows,
                                     const float* vals, const int* xi,
                                     const float* xv, const int* offs,
                                     const int* first, int* scratch, float* y,
                                     int m, int total, int tile, int n_blocks,
                                     int shift, int n_tiles, int* launched,
                                     void* stream) {
  *launched = 0;
  if (total <= 0 || tile < 1 || tile > kMaxTile ||
      (long long)n_blocks * tile < total ||
      (long long)(n_blocks - 1) * tile >= total || shift < 0 ||
      shift > kMaxTileShift || n_tiles < 1 || n_tiles > kMaxTiles ||
      ((long long)(n_tiles - 1) << shift) >= m || ((long long)n_tiles << shift) < m) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int* counts = scratch;
  int* tot = counts + (size_t)n_blocks * n_tiles;
  int* tile_start = tot + n_tiles;
  int* ticket = tile_start + n_tiles + 1;
  int* b_rows = ticket + 1;
  float* b_prods = reinterpret_cast<float*>(b_rows + total);
  cudaError_t err;
  spmspv_scatter_count<<<(unsigned)n_blocks, kWarp, 0, st>>>(
      col_start, rows, xi, offs, first, counts, ticket, total, tile, shift, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  spmspv_scatter_scan<<<(unsigned)((n_tiles + kWarp - 1) / kWarp), kScanThreads, 0, st>>>(
      counts, tot, ticket, tile_start, n_blocks, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 2;
  spmspv_scatter_place<<<(unsigned)n_blocks, kWarp, 0, st>>>(
      col_start, rows, vals, xi, xv, offs, first, counts, tile_start, b_rows, b_prods,
      total, tile, shift, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 3;
  if (shift <= kSmemTileShift) {
    spmspv_scatter_sum<false><<<(unsigned)n_tiles, kSumThreads, sizeof(float) << shift, st>>>(
        tile_start, b_rows, b_prods, y, m, shift);
  } else {
    spmspv_scatter_sum<true><<<(unsigned)n_tiles, kSumThreads, 0, st>>>(
        tile_start, b_rows, b_prods, y, m, shift);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 4;
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
