// Deterministic SpMSpV on Hopper: y = A @ x for a sparse x, where every y_i is
// the left-to-right float32 sum of row i's products in stream order.  Number
// the true products of the touched columns t = 0 .. T - 1:
//   offs[s] = sum of col_len[xi[s']] over s' < s,  T = offs[B],
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
// words per x slot (xi, xv, the gathered col_len and col_start), and writes y
// once: 8*T + 16*B + 4*m bytes for one multiply and one add per product, far
// below the card's operations-per-byte balance.  At serving sizes (T of
// 10^4-10^6) the passes are latency-bound: a product is a chain of dependent
// loads, so the design keeps many warps and many loads in flight.
//
// The host gives only xi, xv and zeroed flag words (one copy); every launch
// shape comes from bounds it knows without reading the device: t_max (the sum
// of the B longest columns) sizes the scratch, the row tiles are fixed per
// operator and x-nnz bucket.  The device finds T and splits the products into
// chunks of 2^cs products (256 .. 2^max_cs, the smallest that leaves at most
// kTargetChunks chunks); blocks walk the chunks grid-stride.  Five launches,
// no float atomics, no zero fill:
//   offsets each block scans 4096 slots' col_len[xi[s]], takes its prefix by
//           a decoupled look-back over the blocks before it (block ids from a
//           ticket, so a block only waits on blocks that started), writes
//           offs (T last), base[s] = col_start[xi[s]] - offs[s] and, for
//           every 256-product grain that starts in a slot, that slot
//           (firsts): each chunk's first slot;
//   count   per chunk: marks each slot's first product in shared memory and
//           takes a block max-scan, so every product finds its slot with one
//           shared-memory read (no search); counts its products per row tile
//           (integer shared-memory atomics: the same every run) into
//           counts[chunk][tile];
//   scan    turns the counts, tile by tile and chunk by chunk within a tile,
//           into each chunk's first position within its tile's bucket; the
//           last block to finish (a ticket) scans the tile totals into each
//           tile's bucket start;
//   place   per chunk again: each of the 8 warps takes a contiguous eighth
//           of the chunk, 32 products at a time in stream order; per-warp
//           tile histograms in shared memory, scanned over (tile, warp), and
//           a lane's rank among its round's products of the same tile
//           (one ballot per bit of the tile) give each product its place, so
//           each bucket holds its products in stream order;
//   sum     one block (16 warps) per row tile of up to 8192 rows: a stable
//           counting sort of its bucket by row (sort_and_sum_tile), least
//           significant digit first in two passes (the low shift / 2 bits
//           of the row, then the rest); each pass gives every warp a
//           contiguous 16th of its input, per-warp digit histograms in
//           shared memory, a scan over (digit, warp) and ranks from one
//           ballot per bit, so every warp walks n / 16 products a pass
//           however the rows are spread.  In shared memory (one block an
//           SM) up to sort_cap products (21 504 for 8192-row tiles, 25 344
//           for 512), in global scratch past it.  Then one thread sums one
//           row in a register from +0.0, and one warp a row of 256 products
//           or more (coalesced loads passed round the lanes), so a hub row
//           costs its own k_i dependent adds, not a walk of the whole
//           bucket.  Tiles of more than 2^kSortShift rows (a y above
//           kMaxTiles * 8192 rows) are summed by one warp in y itself, in
//           bucket order.  Every row of y is written.
// The flags (the look-back words and the two tickets) arrive as zeros with xi
// and xv; count zeroes the look-back words and offsets' ticket once offsets
// is done, place zeroes scan's ticket, so the same staged operands launch
// again.  A T above t_max (xi not distinct columns) writes NaN to every row.
// The three ways a plausible kernel breaks stream order, and what this one does:
//   contraction: the product is rounded with __fmul_rn in `place` and added
//          with __fadd_rn in `sum`, never fused into an FMA;
//   signed zeros: each row starts from +0.0 and adds its first product (as
//          index_add_ into a zero-filled y does), so a row whose only product
//          is -0.0 ends as +0.0;
//   long rows: a row's products may span any number of chunks; the bucket
//          and the in-tile sort carry them in order to one sequential sum,
//          never as partial sums added afterwards.
// The bits depend on neither the chunk split nor the row tiles.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                  // offsets, count, place: 8 warps
constexpr int kWarps = kThreads / kWarp;
constexpr int kSlotsPerThread = 16;
constexpr int kScanSlots = kThreads * kSlotsPerThread;  // slots an offsets block scans
constexpr int kGrainShift = 8;                 // firsts: one slot per 256 products
constexpr int kMinChunkShift = kGrainShift;    // chunks of 256 .. 4096 products
constexpr int kMaxChunkShift = 12;
constexpr int kMaxRounds = (1 << kMaxChunkShift) / kThreads;  // products a lane: 16
constexpr int kTargetChunks = 1024;
constexpr int kSortShift = 13;                 // rows a tile sorts by row (8192)
constexpr int kMaxTiles = 1024;
constexpr int kMaxTileShift = 30;              // rows a tile: 2^30 * 1024 >= any int m
constexpr int kSumThreads = 512;               // sum: 16 warps, each owning R / 16 rows
constexpr int kSumWarps = kSumThreads / kWarp;
constexpr int kDigitMax = 7;                   // bits of the row a sort pass keys on
constexpr int kSortBytes = 200 * 1024;         // a sum block's shared memory: one block an SM
constexpr int kSumBatch = 32;                  // a row's products loaded together
constexpr int kLongRow = 256;                  // a row a warp sums: this many products or more
constexpr int kMaxLong = 256;                  // long rows a tile lists (more: a thread each)
constexpr int kScanThreads = 1024;             // 32 tiles x 32 chunk ranges
constexpr int kScanWarps = kScanThreads / kWarp;
constexpr int kWalkBatch = 8;                  // rounds of 32 products a walk loads together
constexpr int kMaxDynamicSmem = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // a block's own sum
constexpr unsigned long long kPrefix = 2ull << 32;     // its inclusive prefix

struct Add {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// The exclusive scan of v over the block's kW warps of threads in order under
// op (identity id); *all = the whole block's.  Every thread calls it.
template <int kW, class Op>
__device__ __forceinline__ int block_exclusive(int v, int id, Op op, int* s_w, int* all) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = op(x, up);
  }
  const int lower = __shfl_up_sync(kFull, x, 1);  // the lanes below, inclusive
  if (lane == kWarp - 1) s_w[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < kW ? s_w[lane] : id;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int up = __shfl_up_sync(kFull, y, d);
      if (lane >= d) y = op(y, up);
    }
    if (lane < kW) s_w[lane] = y;
  }
  __syncthreads();
  const int before = w > 0 ? s_w[w - 1] : id;
  *all = s_w[kW - 1];
  __syncthreads();  // s_w free for the next call
  return lane > 0 ? op(before, lower) : before;
}

// The lanes of the warp whose key equals this lane's, for keys of `bits`
// bits (>= 0; a negative key matches nothing and is matched by nothing):
// one ballot per bit.
__device__ __forceinline__ unsigned match_bits(int key, int bits) {
  unsigned same = __ballot_sync(kFull, key >= 0);
  for (int k = 0; k < bits; ++k) {
    const bool bit = (key >> k) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    same &= bit ? set : ~set;
  }
  return key >= 0 ? same : 0u;
}

__device__ __forceinline__ int chunk_shift(int total, int max_cs) {
  int cs = kMinChunkShift;
  while (cs < max_cs && (((long long)total + (1 << cs) - 1) >> cs) > kTargetChunks) ++cs;
  return cs;
}

// Products a tile of 2^shift rows sorts in shared memory: what kSortBytes
// leaves beside the row counts, 8 bytes a product (its row, its place after
// the first pass, its value), in whole warps.
__host__ __device__ __forceinline__ int sort_cap(int shift) {
  return (kSortBytes - (4 << shift)) / 8 / kWarp * kWarp;
}

// Whether a tile's bucket can pass sort_cap, so the sum pass needs global
// scratch for its sort (2 * t_max words past the buckets).
__host__ __device__ __forceinline__ bool sorts_in_scratch(int shift, int t_max) {
  return shift <= kSortShift && t_max > sort_cap(shift);
}

__device__ __forceinline__ bool answerable(int total, int t_max) {
  return total >= 0 && total <= t_max;
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }  // no bank conflicts

__global__ void __launch_bounds__(kThreads)
spmspv_scatter_offsets(const int* __restrict__ col_start, const int* __restrict__ col_len,
                       const int* __restrict__ xi, int B, int t_max,
                       unsigned long long* status, int* ticket, int* __restrict__ offs,
                       int* __restrict__ base, int* __restrict__ firsts) {
  __shared__ int s_len[kScanSlots + kScanSlots / kWarp];
  __shared__ int s_w[kWarps];
  __shared__ int s_block, s_prefix;
  if (threadIdx.x == 0) s_block = atomicAdd(ticket, 1);  // ids in the order blocks start
  __syncthreads();
  const int b = s_block;
  const int s0 = b * kScanSlots;
  int len[kSlotsPerThread], start[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {  // coalesced: slot s0 + j * kThreads + thread
    const int s = s0 + j * kThreads + threadIdx.x;
    len[j] = s < B ? __ldg(xi + s) : -1;
  }
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    start[j] = len[j] >= 0 ? __ldg(col_start + len[j]) : 0;
    len[j] = len[j] >= 0 ? __ldg(col_len + len[j]) : 0;
  }
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) s_len[padded(j * kThreads + threadIdx.x)] = len[j];
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {  // this thread's 16 consecutive slots
    len[j] = s_len[padded(threadIdx.x * kSlotsPerThread + j)];
    sum += len[j];
  }
  int block_sum;
  const int before = block_exclusive<kWarps>(sum, 0, Add(), s_w, &block_sum);
  if (threadIdx.x == 0) {
    int prefix = 0;
    volatile unsigned long long* flag = status + b;
    if (b == 0) {
      *flag = kPrefix | (unsigned)block_sum;
    } else {
      *flag = kAggregate | (unsigned)block_sum;
      for (int p = b - 1; p >= 0;) {
        const unsigned long long st = *reinterpret_cast<volatile unsigned long long*>(status + p);
        if (st == 0ull) continue;  // block p has not published yet: it has started
        prefix += (int)(unsigned)st;
        if (st & kPrefix) break;
        --p;
      }
      *flag = kPrefix | (unsigned)(prefix + block_sum);
    }
    s_prefix = prefix;
  }
  __syncthreads();
  long long o = (long long)s_prefix + before;
  const int sb = s0 + threadIdx.x * kSlotsPerThread;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {  // the slots' offsets, back in their order
    s_len[padded(threadIdx.x * kSlotsPerThread + j)] = (int)o;
    o += len[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {  // coalesced again
    const int s = s0 + j * kThreads + threadIdx.x;
    if (s < B) {
      const int os = s_len[padded(j * kThreads + threadIdx.x)];
      offs[s] = os;
      base[s] = start[j] - os;  // product t of slot s is at src = base[s] + t
    }
  }
  o = (long long)s_prefix + before;
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    const int s = sb + j;
    if (s < B) {
      const long long end = o + len[j];
      for (long long g = (o + (1 << kGrainShift) - 1) >> kGrainShift;
           (g << kGrainShift) < end && (g << kGrainShift) < t_max; ++g) {
        firsts[g] = s;  // product g * 256 lies in slot s
      }
      o = end;
      if (s == B - 1) offs[B] = (int)o;
    }
  }
}

// Chunk [t0, t0 + 2^cs)'s slot map in shared memory: s_pos[i] = the position
// in the chunk where the slot of product t0 + i starts (0 for the slot that
// holds t0), s_base[p] = base[s] of the slot starting at p (src = s_base +
// t) and, with kScale, s_xv[p] = xv[s].  Each nonempty slot marks its first
// product, then a block max-scan carries the marks forward.  The slots that
// can start inside the chunk end at the one holding its end (firsts).
template <bool kScale>
__device__ __forceinline__ void stage_chunk(
    const int* __restrict__ offs, const int* __restrict__ base,
    const float* __restrict__ xv, const int* __restrict__ firsts, int B, int total, int t0,
    int cs, int* s_pos, int* s_base, float* s_xv, int* s_w) {
  const int size = 1 << cs;
  const int t_end = min(total, t0 + size);
  for (int i = threadIdx.x; i < size; i += kThreads) s_pos[i] = 0;
  const int lo = __ldg(firsts + (t0 >> kGrainShift));
  const int hi = t_end < total ? __ldg(firsts + (t_end >> kGrainShift)) : B - 1;
  if (threadIdx.x == 0) {
    s_base[0] = __ldg(base + lo);
    if (kScale) s_xv[0] = __ldg(xv + lo);
  }
  __syncthreads();
  for (int s = lo + 1 + threadIdx.x; s <= hi; s += kThreads) {  // offs ascends
    const int o = __ldg(offs + s), o1 = __ldg(offs + s + 1);
    const int b = __ldg(base + s);
    const float v = kScale ? __ldg(xv + s) : 0.0f;
    if (o >= t_end) break;
    if (o1 > o) {  // a nonempty slot's first product
      const int p = o - t0;
      s_pos[p] = p;
      s_base[p] = b;
      if (kScale) s_xv[p] = v;
    }
  }
  __syncthreads();
  const int per = size / kThreads;  // thread t owns positions [t * per, (t + 1) * per)
  const int i0 = threadIdx.x * per;
  int run = 0;
  for (int j = 0; j < per; ++j) run = max(run, s_pos[i0 + j]);
  int all;
  int cur = block_exclusive<kWarps>(run, 0, Max(), s_w, &all);
  for (int j = 0; j < per; ++j) {
    cur = max(cur, s_pos[i0 + j]);
    s_pos[i0 + j] = cur;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
spmspv_scatter_count(const int* __restrict__ rows, const int* __restrict__ offs,
                     const int* __restrict__ base, const int* __restrict__ firsts,
                     int* __restrict__ counts,
                     unsigned long long* status, int n_status, int* ticket, int B,
                     int t_max, int max_cs, int shift, int n_tiles) {
  extern __shared__ int smem[];
  __shared__ int s_w[kWarps];
  int* s_pos = smem;
  int* s_base = s_pos + (1 << max_cs);
  int* hist = s_base + (1 << max_cs);  // n_tiles
  if (blockIdx.x == 0) {  // the offsets pass is done with its flags
    for (int i = threadIdx.x; i < n_status; i += kThreads) status[i] = 0ull;
    if (threadIdx.x == 0) *ticket = 0;
  }
  const int total = __ldg(offs + B);
  if (total <= 0 || !answerable(total, t_max)) return;
  const int cs = chunk_shift(total, max_cs);
  const int n_chunks = (int)(((long long)total + (1 << cs) - 1) >> cs);
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int sub = 1 << (cs - 3);  // a warp's contiguous eighth of the chunk
  const int rounds = sub / kWarp;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t0 = c << cs;
    const int cnt = min(total - t0, 1 << cs);
    for (int k = threadIdx.x; k < n_tiles; k += kThreads) hist[k] = 0;
    stage_chunk<false>(offs, base, nullptr, firsts, B, total, t0, cs, s_pos, s_base, nullptr,
                       s_w);
    int r[kMaxRounds];
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {  // every load in flight before a use
      const int i = w * sub + j * kWarp + lane;
      r[j] = -1;
      if (j < rounds && i < cnt) r[j] = __ldg(rows + s_base[s_pos[i]] + t0 + i);
    }
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {
      if (r[j] >= 0) atomicAdd(hist + (r[j] >> shift), 1);
    }
    __syncthreads();
    int* out = counts + (size_t)c * n_tiles;
    for (int k = threadIdx.x; k < n_tiles; k += kThreads) out[k] = hist[k];
    __syncthreads();
  }
}

// counts[c][k] -> the position of chunk c's first product within tile k's
// bucket (chunks in order), in place; tot[k] = tile k's products.  Lane =
// tile, warp = a range of chunks.  The last block to finish then writes
// tile_start, the exclusive scan of tot, with tile_start[n_tiles] = T.
__global__ void __launch_bounds__(kScanThreads)
spmspv_scatter_scan(int* __restrict__ counts, int* __restrict__ tot, int* __restrict__ ticket,
                    int* __restrict__ tile_start, const int* __restrict__ offs, int B,
                    int t_max, int max_cs, int n_tiles) {
  __shared__ int part[kWarp][kWarp + 1];
  __shared__ int s_w[kScanWarps];
  __shared__ bool last;
  const int total = offs[B];
  int n_chunks = 0;
  if (total > 0 && answerable(total, t_max)) {
    const int cs = chunk_shift(total, max_cs);
    n_chunks = (int)(((long long)total + (1 << cs) - 1) >> cs);
  }
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int k = blockIdx.x * kWarp + lane;
  const int per = (n_chunks + kWarp - 1) / kWarp;
  const int c0 = min(w * per, n_chunks), c1 = min(c0 + per, n_chunks);
  int s = 0;
  if (k < n_tiles) {
#pragma unroll 4
    for (int c = c0; c < c1; ++c) s += counts[(size_t)c * n_tiles + k];
  }
  part[w][lane] = s;
  __syncthreads();
  int run = 0;
  for (int v = 0; v < w; ++v) run += part[v][lane];
  if (k < n_tiles) {
    if (w == kWarp - 1) tot[k] = run + s;
#pragma unroll 4
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
  constexpr int kPer = kMaxTiles / kScanThreads;  // tiles a thread scans
  const int k0 = threadIdx.x * kPer;
  int v[kPer];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = k0 + j < n_tiles ? __ldcg(tot + k0 + j) : 0;
    mine += v[j];
  }
  int all;
  int at = block_exclusive<kScanWarps>(mine, 0, Add(), s_w, &all);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (k0 + j < n_tiles) tile_start[k0 + j] = at;
    at += v[j];
  }
  if (threadIdx.x == 0) tile_start[n_tiles] = all;  // == T
}

__global__ void __launch_bounds__(kThreads)
spmspv_scatter_place(const int* __restrict__ rows, const float* __restrict__ vals,
                     const float* __restrict__ xv, const int* __restrict__ offs,
                     const int* __restrict__ base, const int* __restrict__ firsts,
                     const int* __restrict__ counts,
                     const int* __restrict__ tile_start, int* __restrict__ b_rows,
                     float* __restrict__ b_prods, int* ticket, int B, int t_max, int max_cs,
                     int shift, int n_tiles) {
  extern __shared__ int smem[];
  __shared__ int s_w[kWarps];
  const int size_max = 1 << max_cs;
  int* s_pos = smem;
  int* s_base = s_pos + size_max;
  float* s_xv = reinterpret_cast<float*>(s_base + size_max);
  int* gbase = reinterpret_cast<int*>(s_xv + size_max);  // the chunk's first place per tile
  unsigned short* hist = reinterpret_cast<unsigned short*>(gbase + n_tiles);  // warp x tile
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;  // the scan pass is done with it
  const int total = __ldg(offs + B);
  if (total <= 0 || !answerable(total, t_max)) return;
  const int cs = chunk_shift(total, max_cs);
  const int n_chunks = (int)(((long long)total + (1 << cs) - 1) >> cs);
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const unsigned lower = (1u << lane) - 1u;
  const int sub = 1 << (cs - 3);
  const int rounds = sub / kWarp;
  const int tile_bits = 32 - __clz(n_tiles - 1);  // 0 for one tile
  unsigned short* mine = hist + w * n_tiles;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t0 = c << cs;
    const int cnt = min(total - t0, 1 << cs);
    const int* rel = counts + (size_t)c * n_tiles;
    for (int k = threadIdx.x; k < n_tiles; k += kThreads) {
      gbase[k] = __ldg(tile_start + k) + __ldg(rel + k);
    }
    for (int k = lane; k < n_tiles; k += kWarp) mine[k] = 0;
    stage_chunk<true>(offs, base, xv, firsts, B, total, t0, cs, s_pos, s_base, s_xv, s_w);
    int r[kMaxRounds];
    float p[kMaxRounds];
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {
      const int i = w * sub + j * kWarp + lane;
      r[j] = -1;
      p[j] = 0.0f;
      if (j < rounds && i < cnt) {
        const int a = s_pos[i];
        const int src = s_base[a] + t0 + i;
        r[j] = __ldg(rows + src);
        p[j] = __fmul_rn(__ldg(vals + src), s_xv[a]);  // rounded alone: no FMA later
      }
    }
    unsigned peers[kMaxRounds];
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {  // this warp's products per tile
      if (j < rounds) {
        const int key = r[j] >= 0 ? r[j] >> shift : -1;
        peers[j] = match_bits(key, tile_bits);
        if (key >= 0 && (peers[j] & lower) == 0) mine[key] += __popc(peers[j]);
        __syncwarp();
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_tiles; k += kThreads) {  // scan over (tile, warp)
      int acc = 0;
      for (int v = 0; v < kWarps; ++v) {
        const int n_v = hist[v * n_tiles + k];
        hist[v * n_tiles + k] = (unsigned short)acc;
        acc += n_v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxRounds; ++j) {
      if (j < rounds) {
        const int key = r[j] >= 0 ? r[j] >> shift : -1;
        if (key >= 0) {
          const int pos = gbase[key] + mine[key] + __popc(peers[j] & lower);
          b_rows[pos] = r[j];
          b_prods[pos] = p[j];
        }
        __syncwarp();
        if (key >= 0 && (peers[j] & lower) == 0) mine[key] += __popc(peers[j]);
        __syncwarp();
      }
    }
    __syncthreads();  // shared memory free for the next chunk
  }
}

// One walk of a stable counting-sort pass over a row tile's n products (the
// bucket, in stream order), keyed by a digit of each product's tile-local row.
// Warp w of 16 takes the contiguous 16th [w * q, (w + 1) * q) of the pass's
// input order, 32 products a round, kWalkBatch rounds' loads in flight; cnt
// is the warp's column of the (digit, warp) table.  kPass 0: the input is the
// bucket; stages the rows (kShared: into `row`), counts each row (hist, a
// shared integer atomic a product) and counts the low digit.
// 1: places each bucket index at its low digit's next place (perm), after the
// lower lanes' and the earlier rounds'.  2: the input is perm; counts the high
// digit.  3: writes each product at its high digit's next place (sorted).
template <int kPass, bool kShared, typename Idx>
__device__ __forceinline__ void sort_walk(const int* __restrict__ rows_in,
                                          const float* __restrict__ prods_in, int r0, int n,
                                          int lo_bits, int bits, Idx* row, Idx* perm,
                                          float* sorted, int* hist, int* cnt) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const unsigned lower = (1u << lane) - 1u;
  const int q = (n + kSumWarps - 1) / kSumWarps;
  const int jb = min(n, w * q), je = min(n, jb + q);
  for (int j0 = jb; j0 < je; j0 += kWarp * kWalkBatch) {
    int src[kWalkBatch], r[kWalkBatch];
    float p[kWalkBatch];
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {
      const int j = j0 + u * kWarp + lane;
      src[u] = j < je ? (kPass >= 2 ? (int)perm[j] : j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {  // every load in flight before a use
      r[u] = src[u] < 0 ? -1
             : (kPass == 0 || !kShared) ? __ldg(rows_in + src[u]) - r0 : (int)row[src[u]];
      p[u] = kPass == 3 && src[u] >= 0 ? __ldg(prods_in + src[u]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {
      if (j0 + u * kWarp >= je) break;  // the same for the whole warp
      if (kPass == 0) {
        if (kShared && r[u] >= 0) row[src[u]] = (Idx)r[u];
        if (r[u] >= 0) atomicAdd(hist + r[u], 1);
      }
      const int key = r[u] < 0 ? -1 : kPass < 2 ? r[u] & ((1 << lo_bits) - 1) : r[u] >> lo_bits;
      const unsigned same = match_bits(key, bits);
      if (key >= 0) {
        const int at = cnt[key] + __popc(same & lower);
        if (kPass == 1) perm[at] = (Idx)src[u];
        if (kPass == 3) sorted[at] = p[u];
      }
      __syncwarp();
      if (key >= 0 && (same & lower) == 0) cnt[key] += __popc(same);
      __syncwarp();
    }
  }
}

// The (digit, warp) table of a pass over `bits`-bit digits, warp w's counts
// at dh[w << bits | digit], turned in place into each (digit, warp)'s first
// place: an exclusive scan in (digit, warp) order.  Every thread calls it.
__device__ __forceinline__ void scan_digit_table(int* dh, int bits, int* s_w) {
  constexpr int kPer = (kSumWarps << kDigitMax) / kSumThreads;
  const int size = kSumWarps << bits;
  int v[kPer], mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x * kPer + j;  // digit e / 16, warp e % 16
    v[j] = e < size ? dh[(e % kSumWarps) << bits | e / kSumWarps] : 0;
    mine += v[j];
  }
  int all;
  int at = block_exclusive<kSumWarps>(mine, 0, Add(), s_w, &all);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x * kPer + j;
    if (e < size) dh[(e % kSumWarps) << bits | e / kSumWarps] = at;
    at += v[j];
  }
  __syncthreads();
}

// Sorts one row tile's bucket (n products in stream order, tile-local rows
// b_rows - r0 < R = 2^shift) stably by row and sums each row into y.  A
// least-significant-digit counting sort in two passes, the low shift / 2
// bits of the row and then the rest, each pass a count walk, a scan of its
// (digit, warp) table and a place walk over contiguous 16ths (sort_walk):
// every warp walks n / 16 products a pass however the rows are spread, so
// hub rows that share a tile share its warps too.  kShared: the rows, the
// permutation (unsigned short) and the sorted products sit in shared memory
// (n <= sort_cap); else the permutation and the sorted products are global
// scratch and the rows are read from the bucket.  The row counts, scanned,
// start each row; then one thread sums a row from +0.0, kSumBatch loads in
// flight, and a warp a row of kLongRow products or more (coalesced loads
// passed round the lanes), so a hub row costs its own k_i dependent adds.
template <bool kShared, typename Idx>
__device__ __forceinline__ void sort_and_sum_tile(
    const int* __restrict__ rows_in, const float* __restrict__ prods_in, int n, int r0,
    int shift, int n_rows, Idx* row, Idx* perm, float* sorted, int* hist, int* dh,
    int* s_w, int* n_long, int* long_rows, float* __restrict__ y) {
  const int w = threadIdx.x / kWarp;
  const int R = 1 << shift;
  const int lo = shift / 2, hi = shift - lo;  // hi <= kDigitMax
  if (threadIdx.x == 0) *n_long = 0;
  for (int i = threadIdx.x; i < R; i += kSumThreads) hist[i] = 0;
  for (int i = threadIdx.x; i < kSumWarps << kDigitMax; i += kSumThreads) dh[i] = 0;
  __syncthreads();
  sort_walk<0, kShared>(rows_in, prods_in, r0, n, lo, lo, row, perm, sorted, hist,
                        dh + (w << lo));
  __syncthreads();
  scan_digit_table(dh, lo, s_w);
  sort_walk<1, kShared>(rows_in, prods_in, r0, n, lo, lo, row, perm, sorted, hist,
                        dh + (w << lo));
  __syncthreads();
  for (int i = threadIdx.x; i < kSumWarps << kDigitMax; i += kSumThreads) dh[i] = 0;
  __syncthreads();
  sort_walk<2, kShared>(rows_in, prods_in, r0, n, lo, hi, row, perm, sorted, hist,
                        dh + (w << hi));
  __syncthreads();
  scan_digit_table(dh, hi, s_w);
  sort_walk<3, kShared>(rows_in, prods_in, r0, n, lo, hi, row, perm, sorted, hist,
                        dh + (w << hi));
  // hist: the row counts -> each row's first place (thread t: rows [t * per, ...))
  const int per = (R + kSumThreads - 1) / kSumThreads;
  const int k0 = min(R, threadIdx.x * per), k1 = min(R, k0 + per);
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += hist[k];
  int all;
  int at = block_exclusive<kSumWarps>(mine, 0, Add(), s_w, &all);
  for (int k = k0; k < k1; ++k) {
    const int c = hist[k];
    hist[k] = at;
    at += c;
  }
  __syncthreads();
  // row r holds sorted[hist[r], hist[r + 1]), in stream order; a row of
  // kLongRow products or more goes on the list of long rows (up to kMaxLong)
  for (int r = threadIdx.x; r < n_rows; r += kSumThreads) {
    const int s0 = hist[r];
    const int e = r + 1 < R ? hist[r + 1] : n;
    if (e - s0 >= kLongRow) {
      const int k = atomicAdd(n_long, 1);
      if (k < kMaxLong) {
        long_rows[k] = r;
        continue;
      }
    }
    float a = 0.0f;  // +0.0
    for (int i = s0; i < e; i += kSumBatch) {  // a batch of loads in flight, then its adds
      float v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) v[u] = i + u < e ? sorted[i + u] : 0.0f;
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (i + u < e) a = __fadd_rn(a, v[u]);
      }
    }
    y[r0 + r] = a;
  }
  __syncthreads();
  // each long row by one warp: coalesced loads, every lane adds the row's
  // products in order as they are passed round (the same sum in each lane)
  const int lane = threadIdx.x % kWarp;
  for (int k = w; k < min(*n_long, kMaxLong); k += kSumWarps) {
    const int r = long_rows[k];
    const int s0 = hist[r];
    const int e = r + 1 < R ? hist[r + 1] : n;
    float a = 0.0f;  // +0.0
    for (int i0 = s0; i0 < e; i0 += kWarp * kWalkBatch) {
      float v[kWalkBatch];
#pragma unroll
      for (int u = 0; u < kWalkBatch; ++u) {
        const int i = i0 + u * kWarp + lane;
        v[u] = i < e ? sorted[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kWalkBatch; ++u) {
        const int left = e - (i0 + u * kWarp);  // the same in every lane
#pragma unroll
        for (int l = 0; l < kWarp; ++l) {
          const float t = __shfl_sync(kFull, v[u], l);
          if (l < left) a = __fadd_rn(a, t);
        }
      }
    }
    if (lane == 0) y[r0 + r] = a;
  }
}

// kInY: the tile's rows (more than 2^kSortShift) are summed by one warp in y
// itself, in bucket order; else the tile is sorted by row and each row summed
// by one thread (sort_and_sum_tile).
template <bool kInY>
__global__ void __launch_bounds__(kSumThreads)
spmspv_scatter_sum(const int* __restrict__ tile_start, const int* __restrict__ b_rows,
                   const float* __restrict__ b_prods, int* __restrict__ perm,
                   float* __restrict__ sorted, float* __restrict__ y,
                   const int* __restrict__ offs, int B, int t_max, int m, int shift,
                   int cap) {
  extern __shared__ int smem[];
  __shared__ int s_dh[kSumWarps << kDigitMax];  // the sort's (digit, warp) table
  __shared__ int s_long[kMaxLong + 1];          // the tile's long rows, then their count
  __shared__ int s_w[kSumWarps];
  __shared__ float s_p[kWarp];
  const long long r0l = (long long)blockIdx.x << shift;  // < m
  const int r0 = (int)r0l;
  const int n_rows = (int)min(1ll << shift, (long long)m - r0l);
  if (!answerable(offs[B], t_max)) {  // xi were not distinct columns: no answer
    for (int i = threadIdx.x; i < n_rows; i += kSumThreads) y[r0 + i] = __int_as_float(0x7fffffff);
    return;
  }
  const int beg = tile_start[blockIdx.x], end = tile_start[blockIdx.x + 1];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const unsigned lower = (1u << lane) - 1u;
  if (kInY) {
    float* acc = y + r0;
    for (int i = threadIdx.x; i < n_rows; i += kSumThreads) acc[i] = 0.0f;  // +0.0
    __syncthreads();
    if (w != 0) return;
    for (int i0 = beg; i0 < end; i0 += kWarp * kWalkBatch) {
      int lr[kWalkBatch];
      float lp[kWalkBatch];
#pragma unroll
      for (int u = 0; u < kWalkBatch; ++u) {
        const int i = i0 + u * kWarp + lane;
        lr[u] = i < end ? b_rows[i] - r0 : -1;
        lp[u] = i < end ? b_prods[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kWalkBatch; ++u) {
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
    return;
  }
  const int n = end - beg;
  int* hist = smem;  // R
  if (n <= cap) {
    unsigned short* row = reinterpret_cast<unsigned short*>(hist + (1 << shift));
    unsigned short* s_perm = row + cap;
    float* s_sorted = reinterpret_cast<float*>(s_perm + cap);
    sort_and_sum_tile<true, unsigned short>(b_rows + beg, b_prods + beg, n, r0, shift,
                                            n_rows, row, s_perm, s_sorted, hist, s_dh, s_w,
                                            s_long + kMaxLong, s_long, y);
  } else {  // only where t_max > cap: the launch then gives the scratch
    sort_and_sum_tile<false, int>(b_rows + beg, b_prods + beg, n, r0, shift, n_rows,
                                  nullptr, perm + beg, sorted + beg, hist, s_dh, s_w,
                                  s_long + kMaxLong, s_long, y);
  }
}

cudaError_t allow_dynamic_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool done[64];
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(spmspv_scatter_count, attr, kMaxDynamicSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(spmspv_scatter_place, attr, kMaxDynamicSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(spmspv_scatter_sum<false>, attr, kMaxDynamicSmem)) !=
          cudaSuccess) {
    return err;
  }
  if (dev >= 0 && dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// The five passes in order on `stream`, each checked right after its launch.
// `flags` (int32, 8-byte aligned, zero on entry and again on return): the
// offsets pass's look-back words (2 ints per 4096 slots), its ticket, the
// scan pass's ticket.  `scratch` (int32) holds, in order: offs (B + 1),
// base (B: col_start[xi[s]] - offs[s]), firsts (t_max / 256 + 1), counts
// (n_chunks_max x n_tiles), tot (n_tiles), tile_start (n_tiles + 1), the
// bucket rows and the bucket products (t_max each) and, where a bucket can
// pass sort_cap (sorts_in_scratch), the sort's permutation and the sorted
// products (t_max each).
// *launched is the count of passes launched; a refused pass stops the
// sequence and returns its error.
extern "C" int spmspv_scatter_launch(const int* col_start, const int* col_len,
                                     const int* rows, const float* vals, const int* xi,
                                     const float* xv, int* flags, int* scratch, float* y,
                                     int m, int B, int t_max, int max_cs, int shift,
                                     int n_tiles, int grid, int n_chunks_max, int* launched,
                                     void* stream) {
  *launched = 0;
  // the most chunks any T <= t_max splits into (chunk_shift)
  const long long fine = ((long long)t_max + (1 << kGrainShift) - 1) >> kGrainShift;
  const long long wide = max_cs >= kMinChunkShift && max_cs <= kMaxChunkShift
                             ? ((long long)t_max + (1 << max_cs) - 1) >> max_cs : 0;
  const long long cap = wide > kTargetChunks ? wide : kTargetChunks;
  const long long bound = fine < cap ? fine : cap;
  if (m < 1 || B < 1 || t_max < 0 || max_cs < kMinChunkShift || max_cs > kMaxChunkShift ||
      shift < 5 || shift > kMaxTileShift || n_tiles < 1 || n_tiles > kMaxTiles ||
      ((long long)(n_tiles - 1) << shift) >= m || ((long long)n_tiles << shift) < m ||
      grid < 1 || n_chunks_max < bound) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_scan = (B + kScanSlots - 1) / kScanSlots;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(flags);
  int* ticket_offsets = flags + 2 * n_scan;
  int* ticket_scan = ticket_offsets + 1;
  int* offs = scratch;
  int* base = offs + B + 1;
  int* firsts = base + B;
  int* counts = firsts + (t_max >> kGrainShift) + 1;
  int* tot = counts + (size_t)n_chunks_max * n_tiles;
  int* tile_start = tot + n_tiles;
  int* b_rows = tile_start + n_tiles + 1;
  float* b_prods = reinterpret_cast<float*>(b_rows + t_max);
  const bool in_scratch = sorts_in_scratch(shift, t_max);
  int* perm = in_scratch ? reinterpret_cast<int*>(b_prods + t_max) : nullptr;
  float* sorted = in_scratch ? reinterpret_cast<float*>(perm + t_max) : nullptr;
  const size_t chunk = (size_t)1 << max_cs;
  const size_t smem_count = (2 * chunk + n_tiles) * sizeof(int);
  const size_t smem_place = (3 * chunk + n_tiles) * sizeof(int) +
                            (size_t)kWarps * n_tiles * sizeof(unsigned short);
  const bool in_y = shift > kSortShift;
  const size_t smem_sum = in_y ? 0 : (size_t)kSortBytes;  // <= kMaxDynamicSmem
  cudaError_t err;
  if ((err = allow_dynamic_smem()) != cudaSuccess) return (int)err;
  spmspv_scatter_offsets<<<(unsigned)n_scan, kThreads, 0, st>>>(
      col_start, col_len, xi, B, t_max, status, ticket_offsets, offs, base, firsts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 1;
  spmspv_scatter_count<<<(unsigned)grid, kThreads, smem_count, st>>>(
      rows, offs, base, firsts, counts, status, n_scan, ticket_offsets, B, t_max, max_cs, shift,
      n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 2;
  spmspv_scatter_scan<<<(unsigned)((n_tiles + kWarp - 1) / kWarp), kScanThreads, 0, st>>>(
      counts, tot, ticket_scan, tile_start, offs, B, t_max, max_cs, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 3;
  spmspv_scatter_place<<<(unsigned)grid, kThreads, smem_place, st>>>(
      rows, vals, xv, offs, base, firsts, counts, tile_start, b_rows, b_prods, ticket_scan, B,
      t_max, max_cs, shift, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 4;
  if (in_y) {
    spmspv_scatter_sum<true><<<(unsigned)n_tiles, kSumThreads, 0, st>>>(
        tile_start, b_rows, b_prods, perm, sorted, y, offs, B, t_max, m, shift, 0);
  } else {
    spmspv_scatter_sum<false><<<(unsigned)n_tiles, kSumThreads, smem_sum, st>>>(
        tile_start, b_rows, b_prods, perm, sorted, y, offs, B, t_max, m, shift,
        sort_cap(shift));
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  *launched = 5;
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
