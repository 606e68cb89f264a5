// BCSR SpMM on Hopper: Y[r*bm + i, j] = sum over the stored blocks g of block
// row r, sum_t blocks[g, i, t] * X[block_cols[g]*bk + t, j].
//
// Replaces the TPU kernel src/repro/kernels/bcsr_spmm.py::bcsr_spmm_pallas.
//
// Bound on this card.  The format stores 4*bm*bk bytes per block whatever
// its fill, so the stored stream sets a floor of its own: bytes at k <= 16
// (an 8x8 block is 256 bytes for 128*k flops), float32 FMAs at k = 64 (no
// tensor cores: TF32 would change the numerics).  A kernel that gives each
// output element its own thread is bound by neither but by its load/store
// units: two loads per FMA, each X element loaded again by each of the bm
// rows and each A element by every N tile.
//
// Design.  The unit of work is one warp on (block row, 8-row group, N tile);
// a block row's blocks are contiguous (sorted by row, block-row pointer
// indptr), so the warp walks them in stored order and sums each output in a
// fixed order: no atomics, bitwise repeatable, and an empty block row writes
// zeros.  Three paths, chosen by the launcher:
//
// * wide (k not in {1, 4}): register tiles.  Lane (p, q) of P inner
//   partitions x 32/P column groups holds 8 rows x C columns of Y.  The
//   warp's 8-row slices of A stream through a per-warp ring of shared-memory
//   stages (16-byte cp.async, kStages - 1 stages in flight while one is
//   consumed; the role of the TPU kernel's slab pipeline), with their block
//   columns (4-byte cp.async) beside them.  Per 4 inner steps a lane loads 4
//   X rows of C columns and 8 float4 broadcasts of A for 32*C FMAs, so each
//   X element feeds 8 FMAs and each A element C.  Partitions split the inner
//   dimension and meet in a fixed xor-shuffle tree.  Columns past k are
//   masked, so any k runs here (N tiles of 64 for k >= 32, of 16 below).
//   What is left bounds it at k = 64: an 8x8 block brings 2 KB of X rows
//   for 256 bytes of A, so each SM reads 8x the stored bytes through L1.
// * narrow (k in {1, 4}): the outputs are too few to tile, so lanes split the
//   inner dimension instead.  Each lane takes 16-byte slices of the stored
//   values (the next four in flight while the current four gather their X
//   elements: one float4 of X per A float4 at k = 1, four at k = 4), and
//   each row is reduced by a fixed shuffle pattern.
// * generic (bk not in {8, 16, 128} or bm not a multiple of 8): each lane
//   owns one column of 8 rows, A and X read straight from global memory
//   with scalar loads; rows past bm and columns past k are masked.  Any
//   block shape runs, so the launcher refuses none.
//
// Every path gives one warp to each (block row, 8-row group, N tile) on a
// one-dimensional grid, the N tiles of a row group on neighbouring warps.
// The wide and narrow paths read blocks and X in 8- and 16-byte vectors, so
// both must start on a 16-byte boundary (the wrapper checks it).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // warps per block on every path
constexpr int kStages = 3;  // shared-memory stages in the wide path's ring
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of a warp's ring: kBlocks 8-row slices of (8, BK) floats, at
// least 2 KB, and their block columns.
template <int BK>
struct Ring {
  static constexpr int kSlice = 8 * BK;
  static constexpr int kBlocks = kSlice >= 512 ? 1 : 512 / kSlice;
  static constexpr int kStageFloats = kBlocks * kSlice;
  static constexpr int kColInts = (kBlocks + 3) / 4 * 4;
  static constexpr int kWarpFloats = kStages * (kStageFloats + kColInts);
  static constexpr size_t kSmemBytes = (size_t)kWarps * kWarpFloats * 4;
};

// C consecutive X elements at p (columns j0 .. j0 + C - 1), zero past k.
template <int C>
__device__ __forceinline__ void load_x(float (&v)[C], const float* p, int j0,
                                       int k, bool vec) {
  if constexpr (C == 2) {
    if (vec) {  // k even, so j0 < k covers both columns
      const float2 t = j0 < k ? __ldg(reinterpret_cast<const float2*>(p))
                              : make_float2(0.f, 0.f);
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = j0 + c < k ? __ldg(p + c) : 0.f;
}

// Warp w of block b takes unit u = b * kWarps + w: N tile u mod n_tiles of
// (block row, 8-row group) u / n_tiles, so the warps on the N tiles of one
// block row run side by side and the second reads its A slices from L2.
template <int BK, int C, int P>
__global__ void __launch_bounds__(kWarps * 32)
bcsr_wide(const int* __restrict__ indptr, const int* __restrict__ block_cols,
          const float* __restrict__ blocks, const float* __restrict__ x,
          float* __restrict__ y, int gm, int bm, int k, int n_rg) {
  using R = Ring<BK>;
  constexpr int Q = 32 / P;   // column groups
  constexpr int TG = BK / 4;  // float4 groups along a slice row
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (k + Q * C - 1) / (Q * C);
  const long long unit = (long long)blockIdx.x * kWarps + warp;
  if (unit >= (long long)gm * n_rg * n_tiles) return;  // the whole warp leaves
  const int row_unit = (int)(unit / n_tiles);
  const int brow = row_unit / n_rg;
  const int r0 = (row_unit - brow * n_rg) * 8;
  const int p = lane / Q;
  const int j0 = (int)(unit - (long long)row_unit * n_tiles) * (Q * C) + (lane % Q) * C;
  const bool vec = (k % C) == 0;

  float* ring = reinterpret_cast<float*>(smem4) + warp * R::kWarpFloats;
  int* ring_cols = reinterpret_cast<int*>(ring + kStages * R::kStageFloats);
  const int g0 = indptr[brow];
  const int nb = indptr[brow + 1] - g0;
  const int n_ch = (nb + R::kBlocks - 1) / R::kBlocks;

  auto issue = [&](int ch) {
    if (ch < n_ch) {
      const int gb = g0 + ch * R::kBlocks;
      const int nbc = min(R::kBlocks, nb - ch * R::kBlocks);
      float* dst = ring + (ch % kStages) * R::kStageFloats;
      const float* src = blocks + ((long long)gb * bm + r0) * BK;
      for (int f = lane; f < nbc * (R::kSlice / 4); f += 32) {
        const int b = f / (R::kSlice / 4);
        const int off = (f % (R::kSlice / 4)) * 4;
        cp_async16(dst + b * R::kSlice + off, src + (long long)b * bm * BK + off);
      }
      if (lane < nbc)
        cp_async4(ring_cols + (ch % kStages) * R::kColInts + lane,
                  block_cols + gb + lane);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float acc[8][C];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int ch = 0; ch < n_ch; ++ch) {
    issue(ch + kStages - 1);
    cp_async_wait<kStages - 1>();  // this lane's copies of stage ch landed
    __syncwarp();                  // and every other lane's
    const float* a_st = ring + (ch % kStages) * R::kStageFloats;
    const int* c_st = ring_cols + (ch % kStages) * R::kColInts;
    const int n_idx = min(R::kBlocks, nb - ch * R::kBlocks) * TG;
#pragma unroll 2
    for (int idx = p; idx < n_idx; idx += P) {
      const int b = idx / TG;
      const int tg = idx % TG;
      const float* xr = x + ((long long)c_st[b] * BK + tg * 4) * k + j0;
      float xv[4][C];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_x<C>(xv[u], xr + (long long)u * k, j0, k, vec);
      const float* ar = a_st + b * R::kSlice + tg * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(ar + i * BK);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[i][c] = fmaf(av.x, xv[0][c], acc[i][c]);
          acc[i][c] = fmaf(av.y, xv[1][c], acc[i][c]);
          acc[i][c] = fmaf(av.z, xv[2][c], acc[i][c]);
          acc[i][c] = fmaf(av.w, xv[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();  // every lane is done with stage ch before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int off = Q; off < 32; off <<= 1)
        acc[i][c] += __shfl_xor_sync(kFull, acc[i][c], off);
  // Every partition now holds the sums; partition p stores rows i = p mod P.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i % P != p) continue;
    float* yr = y + ((long long)brow * bm + r0 + i) * k + j0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (j0 + c < k) yr[c] = acc[i][c];
  }
}

// A 16-byte slice of stored values, read once: keep it out of L1, where X
// is being reused.
__device__ __forceinline__ float4 ld_stream(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

// acc[c] += a . X[xr + 4 rows, c]: the 4 X rows are K floats apart.
template <int K>
__device__ __forceinline__ void dot4(float (&acc)[K], float4 a, const float* xr) {
  if constexpr (K == 1) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(xr));
    acc[0] = fmaf(a.x, xv.x, acc[0]);
    acc[0] = fmaf(a.y, xv.y, acc[0]);
    acc[0] = fmaf(a.z, xv.z, acc[0]);
    acc[0] = fmaf(a.w, xv.w, acc[0]);
  } else {
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xr) + t);
      acc[0] = fmaf(av[t], xv.x, acc[0]);
      acc[1] = fmaf(av[t], xv.y, acc[1]);
      acc[2] = fmaf(av[t], xv.z, acc[2]);
      acc[3] = fmaf(av[t], xv.w, acc[3]);
    }
  }
}

template <int K>
__device__ __forceinline__ void store_row(float* yr, const float (&acc)[K]) {
  if constexpr (K == 1) {
    yr[0] = acc[0];
  } else {
    *reinterpret_cast<float4*>(yr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <int BK, int K>
__global__ void __launch_bounds__(kWarps * 32)
bcsr_narrow(const int* __restrict__ indptr, const int* __restrict__ block_cols,
            const float* __restrict__ blocks, const float* __restrict__ x,
            float* __restrict__ y, int gm, int bm, int n_rg) {
  static_assert(K == 1 || K == 4, "narrow path takes k = 1 or 4");
  constexpr int TG = BK / 4;  // float4s along a slice row
  constexpr int F = 8 * TG;   // float4s in an 8-row slice
  constexpr int U = 4;        // independent slices in flight per lane
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarps + warp;
  if (unit >= (long long)gm * n_rg) return;
  const int brow = (int)(unit / n_rg);
  const int r0 = (int)(unit % n_rg) * 8;
  const int g0 = indptr[brow];
  const int g1 = indptr[brow + 1];
  if constexpr (F <= 32) {
    // A warp load covers 32 / F whole slices; lane (bsub, i, tq) keeps row i.
    constexpr int BPI = 32 / F;
    const int bsub = lane / F;
    const int i = (lane % F) / TG;
    const int tq = lane % TG;
    float acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = 0.f;
    // The next U slices are loaded before the X gathers of the current U,
    // so the stored stream stays in flight behind the gathers.
    float4 a[U], a_next[U];
    int col[U], col_next[U];
    auto fetch = [&](float4 (&av)[U], int (&cv)[U], int g) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int gg = g + u * BPI;
        if (gg < g1) {
          av[u] = ld_stream(blocks + ((long long)gg * bm + r0 + i) * BK + tq * 4);
          cv[u] = __ldg(block_cols + gg);
        }
      }
    };
    fetch(a, col, g0 + bsub);
    for (int g = g0 + bsub; g < g1; g += BPI * U) {
      fetch(a_next, col_next, g + BPI * U);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u * BPI < g1)
          dot4<K>(acc, a[u], x + ((long long)col[u] * BK + tq * 4) * K);
        a[u] = a_next[u];
        col[u] = col_next[u];
      }
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
#pragma unroll
      for (int off = 1; off < TG; off <<= 1)
        acc[c] += __shfl_xor_sync(kFull, acc[c], off);
#pragma unroll
      for (int off = F; off < 32; off <<= 1)
        acc[c] += __shfl_xor_sync(kFull, acc[c], off);
    }
    if (lane < F && tq == 0)
      store_row<K>(y + ((long long)brow * bm + r0 + i) * K, acc);
  } else {
    // A slice row is one warp load: lane l takes columns 4l .. 4l + 3 of
    // every row, and one X gather serves all 8 rows.
    static_assert(TG == 32, "narrow path takes bk = 8, 16 or 128");
    float acc[8][K];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c) acc[i][c] = 0.f;
    for (int g = g0; g < g1; ++g) {
      const float* ab = blocks + ((long long)g * bm + r0) * BK + lane * 4;
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ld_stream(ab + i * BK);
      const float* xr = x + ((long long)__ldg(block_cols + g) * BK + lane * 4) * K;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot4<K>(acc[i], a[i], xr);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < K; ++c)
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          acc[i][c] += __shfl_xor_sync(kFull, acc[i][c], off);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane == i) store_row<K>(y + ((long long)brow * bm + r0 + i) * K, acc[i]);
  }
}

// Any block shape: lane q of the warp owns column j = tile * 32 + q of 8
// rows; A is read straight from global memory (each value a broadcast).
__global__ void __launch_bounds__(kWarps * 32)
bcsr_generic(const int* __restrict__ indptr, const int* __restrict__ block_cols,
             const float* __restrict__ blocks, const float* __restrict__ x,
             float* __restrict__ y, int gm, int bm, int bk, int k, int n_rg) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (k + 31) / 32;
  const long long unit = (long long)blockIdx.x * kWarps + warp;
  if (unit >= (long long)gm * n_rg * n_tiles) return;
  const int row_unit = (int)(unit / n_tiles);
  const int brow = row_unit / n_rg;
  const int r0 = (row_unit - brow * n_rg) * 8;
  const int rows = min(8, bm - r0);
  const int j = (int)(unit - (long long)row_unit * n_tiles) * 32 + lane;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const int g1 = indptr[brow + 1];
  for (int g = indptr[brow]; g < g1; ++g) {
    const float* a = blocks + ((long long)g * bm + r0) * bk;
    const float* xr = x + (long long)__ldg(block_cols + g) * bk * k + j;
    for (int t = 0; t < bk; ++t) {
      const float xv = j < k ? __ldg(xr + (long long)t * k) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < rows) acc[i] = fmaf(__ldg(a + (long long)i * bk + t), xv, acc[i]);
    }
  }
  if (j < k) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < rows) y[((long long)brow * bm + r0 + i) * k + j] = acc[i];
  }
}

struct Launch {
  int gm, bm, k, n_rg;
  // Blocks of kWarps warps, one warp per (block row, 8-row group, N tile of
  // `tile` columns); 0 when the grid would not fit.
  unsigned blocks(int tile) const {
    const long long units = (long long)gm * n_rg * ((k + tile - 1) / tile);
    const long long b = (units + kWarps - 1) / kWarps;
    return b > 0x7fffffffLL ? 0u : (unsigned)b;
  }
};

template <int BK, int C, int P>
int launch_wide(const Launch& L, const int* indptr, const int* block_cols,
                const float* blocks, const float* x, float* y, cudaStream_t s) {
  auto kernel = bcsr_wide<BK, C, P>;
  const unsigned nb = L.blocks(32 / P * C);
  if (nb == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = Ring<BK>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb, kWarps * 32, smem, s>>>(indptr, block_cols, blocks, x, y, L.gm,
                                       L.bm, L.k, L.n_rg);
  return (int)cudaGetLastError();
}

// The specialised paths for block width BK (bm a multiple of 8).
template <int BK>
int launch_bk(const Launch& L, const int* indptr, const int* block_cols,
              const float* blocks, const float* x, float* y, cudaStream_t s) {
  if (L.k == 1 || L.k == 4) {
    const unsigned nb = L.blocks(L.k);
    if (nb == 0) return (int)cudaErrorInvalidConfiguration;
    if (L.k == 1)
      bcsr_narrow<BK, 1><<<nb, kWarps * 32, 0, s>>>(indptr, block_cols, blocks,
                                                     x, y, L.gm, L.bm, L.n_rg);
    else
      bcsr_narrow<BK, 4><<<nb, kWarps * 32, 0, s>>>(indptr, block_cols, blocks,
                                                     x, y, L.gm, L.bm, L.n_rg);
    return (int)cudaGetLastError();
  }
  if (L.k >= 32) return launch_wide<BK, 2, 1>(L, indptr, block_cols, blocks, x, y, s);
  return launch_wide<BK, 2, 4>(L, indptr, block_cols, blocks, x, y, s);
}

// ---------------------------------------------------------------------------
// bf16 operands: the sparse FFN's path (blocks and X in bf16, as the model
// stores them; the TPU kernel takes the same and accumulates in float32 with
// preferred_element_type).  Each bf16 value widens to float in registers
// (its 16 bits are the top half of a float), every product of two of them is
// exact in float32, and Y is float32: only the order of the sums differs from
// the plain version.  The float32 paths above are untouched.
//
// Bound.  At decode (k = the slot count) the stored blocks are nearly all
// the bytes, 2 per stored value: bytes-bound.  The unit of work is one CTA
// per (block row, 8-row group, N tile of KT columns); its kWarps warps split
// the row's stored blocks (warp w takes blocks w, w + kWarps, ...), so even a
// block row of 15 blocks keeps 8 warps' 16-byte loads in flight.  In a warp,
// L = bk / 8 lanes read one slice row of 8 x 16 bytes, so RP = 32 / L rows
// go per warp load and each lane keeps MR rows of 8 values; the next block's
// values are loaded before the current block's FMAs.  A lane's partial sums
// meet in a fixed xor-shuffle tree over its L lanes, then the warps' partial
// sums meet in shared memory in warp order: no atomics, bitwise repeatable.
// X is read from global memory (16 bytes per row at k = 8n, 8 at k = 4n, 16
// for the 8 rows at k = 1, else by element).  Simple first: no tensor cores
// (a later redesign: mma/wgmma in bf16), each N tile of a row group reads
// the row's blocks again (from L2).  Takes bk in {8, 16, 32, 64, 128, 256}
// and any bm.
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void widen8(const uint4 v, float (&f)[8]) {
  f[0] = bf_lo(v.x); f[1] = bf_hi(v.x); f[2] = bf_lo(v.y); f[3] = bf_hi(v.y);
  f[4] = bf_lo(v.z); f[5] = bf_hi(v.z); f[6] = bf_lo(v.w); f[7] = bf_hi(v.w);
}

// KT consecutive bf16 X elements (columns j0 .. j0 + KT - 1 of one row) as
// floats, zero past k; `vec`: k is a multiple of KT, so one vector load.
template <int KT>
__device__ __forceinline__ void load_x_bf16(float (&v)[KT],
                                            const unsigned short* p, int j0,
                                            int k, bool vec) {
  if constexpr (KT == 8) {
    if (vec) {
      float f[8];
      widen8(j0 < k ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0), f);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = f[q];
      return;
    }
  }
  if constexpr (KT == 4) {
    if (vec) {
      const uint2 t = j0 < k ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
      v[0] = bf_lo(t.x); v[1] = bf_hi(t.x); v[2] = bf_lo(t.y); v[3] = bf_hi(t.y);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < KT; ++q)
    v[q] = j0 + q < k ? __uint_as_float((unsigned)__ldg(p + q) << 16) : 0.f;
}

template <int L, int KT>
__global__ void __launch_bounds__(kWarps * 32)
bcsr_bf16(const int* __restrict__ indptr, const int* __restrict__ block_cols,
          const unsigned short* __restrict__ blocks,
          const unsigned short* __restrict__ x, float* __restrict__ y, int bm,
          int k, int n_rg) {
  constexpr int BK = 8 * L;
  constexpr int RP = 32 / L;                 // slice rows per warp load
  constexpr int MR = RP >= 8 ? 1 : 8 / RP;   // rows a lane keeps
  __shared__ float part[kWarps][8][KT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (k + KT - 1) / KT;
  const int row_unit = blockIdx.x / n_tiles;
  const int brow = row_unit / n_rg;
  const int r0 = (row_unit - brow * n_rg) * 8;
  const int j0 = (blockIdx.x - row_unit * n_tiles) * KT;
  const int sub = lane / L;  // slice row within a warp load
  const int c = lane % L;    // 16-byte chunk of that row: columns 8c .. 8c + 7
  const bool vec = (k % KT) == 0;
  bool live[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int i = sub + m * RP;
    live[m] = i < 8 && r0 + i < bm;
  }

  float acc[MR][KT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int q = 0; q < KT; ++q) acc[m][q] = 0.f;

  const int g1 = indptr[brow + 1];
  auto fetch = [&](uint4 (&a)[MR], int g) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      a[m] = make_uint4(0, 0, 0, 0);
      if (g < g1 && live[m])
        a[m] = __ldcs(reinterpret_cast<const uint4*>(
            blocks + ((long long)g * bm + r0 + sub + m * RP) * BK + c * 8));
    }
  };
  uint4 a[MR], a_next[MR];
  int g = indptr[brow] + warp;
  fetch(a, g);
  for (; g < g1; g += kWarps) {
    fetch(a_next, g + kWarps);
    float af[MR][8];
#pragma unroll
    for (int m = 0; m < MR; ++m) widen8(a[m], af[m]);
    const long long xrow = (long long)__ldg(block_cols + g) * BK + c * 8;
    if constexpr (KT == 1) {
      // k == 1: the chunk's 8 X rows are 8 consecutive values
      float xv[8];
      widen8(__ldg(reinterpret_cast<const uint4*>(x + xrow)), xv);
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[m][0] = fmaf(af[m][t], xv[t], acc[m][0]);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float xv[KT];
        load_x_bf16<KT>(xv, x + (xrow + t) * k + j0, j0, k, vec);
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int q = 0; q < KT; ++q) acc[m][q] = fmaf(af[m][t], xv[q], acc[m][q]);
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) a[m] = a_next[m];
  }

#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int q = 0; q < KT; ++q)
#pragma unroll
      for (int off = 1; off < L; off <<= 1)
        acc[m][q] += __shfl_xor_sync(kFull, acc[m][q], off);
  if (c == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int i = sub + m * RP;
      if (i < 8)
#pragma unroll
        for (int q = 0; q < KT; ++q) part[warp][i][q] = acc[m][q];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 8 * KT) {
    const int i = t / KT;
    const int q = t % KT;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][i][q];
    if (r0 + i < bm && j0 + q < k) y[((long long)brow * bm + r0 + i) * k + j0 + q] = s;
  }
}

template <int L>
int launch_bf16_bk(const int* indptr, const int* block_cols,
                   const unsigned short* blocks, const unsigned short* x,
                   float* y, int gm, int bm, int k, int n_rg, cudaStream_t s) {
  const int kt = k == 1 ? 1 : k <= 4 ? 4 : 8;
  const long long nb = (long long)gm * n_rg * ((k + kt - 1) / kt);
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (kt == 1)
    bcsr_bf16<L, 1><<<(unsigned)nb, kWarps * 32, 0, s>>>(indptr, block_cols,
                                                          blocks, x, y, bm, k, n_rg);
  else if (kt == 4)
    bcsr_bf16<L, 4><<<(unsigned)nb, kWarps * 32, 0, s>>>(indptr, block_cols,
                                                          blocks, x, y, bm, k, n_rg);
  else
    bcsr_bf16<L, 8><<<(unsigned)nb, kWarps * 32, 0, s>>>(indptr, block_cols,
                                                          blocks, x, y, bm, k, n_rg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bcsr_spmm_launch(const int* indptr, const int* block_cols,
                                const float* blocks, const float* x, float* y,
                                int gm, int bm, int bk, int k, void* stream) {
  if (gm <= 0 || k <= 0) return 0;
  if (bm < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  const Launch L{gm, bm, k, (bm + 7) / 8};
  if ((long long)gm * L.n_rg > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm % 8 == 0) {
    if (bk == 8) return launch_bk<8>(L, indptr, block_cols, blocks, x, y, s);
    if (bk == 16) return launch_bk<16>(L, indptr, block_cols, blocks, x, y, s);
    if (bk == 128) return launch_bk<128>(L, indptr, block_cols, blocks, x, y, s);
  }
  const unsigned nb = L.blocks(32);
  if (nb == 0) return (int)cudaErrorInvalidConfiguration;
  bcsr_generic<<<nb, kWarps * 32, 0, s>>>(indptr, block_cols, blocks, x, y, gm,
                                          bm, bk, k, L.n_rg);
  return (int)cudaGetLastError();
}

// Y (float32) = A @ X with bf16 blocks and X: bk in {8, 16, 32, 64, 128, 256}.
extern "C" int bcsr_spmm_bf16_launch(const int* indptr, const int* block_cols,
                                     const unsigned short* blocks,
                                     const unsigned short* x, float* y, int gm,
                                     int bm, int bk, int k, void* stream) {
  if (gm <= 0 || k <= 0) return 0;
  if (bm < 1) return (int)cudaErrorInvalidValue;
  const int n_rg = (bm + 7) / 8;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bk) {
    case 8: return launch_bf16_bk<1>(indptr, block_cols, blocks, x, y, gm, bm, k, n_rg, s);
    case 16: return launch_bf16_bk<2>(indptr, block_cols, blocks, x, y, gm, bm, k, n_rg, s);
    case 32: return launch_bf16_bk<4>(indptr, block_cols, blocks, x, y, gm, bm, k, n_rg, s);
    case 64: return launch_bf16_bk<8>(indptr, block_cols, blocks, x, y, gm, bm, k, n_rg, s);
    case 128: return launch_bf16_bk<16>(indptr, block_cols, blocks, x, y, gm, bm, k, n_rg, s);
    case 256: return launch_bf16_bk<32>(indptr, block_cols, blocks, x, y, gm, bm, k, n_rg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
