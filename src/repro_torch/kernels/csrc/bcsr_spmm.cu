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
// bf16 operands: the sparse FFN's path.  Blocks and X are bf16, as the model
// stores them, and Y is float32: the TPU kernel
// (src/repro/kernels/bcsr_spmm.py:56, bcsr_spmm_pallas) takes the same and
// multiplies each block on its matrix unit, jnp.dot(..., preferred_element_type
// =float32).  Every product of two bf16 values is exact in float32, so only the
// order of the sums differs from the plain version.  The float32 paths above
// are untouched.
//
// Bound on this card.  At decode (k = the slot count, 1 to 4) the stored
// blocks are nearly all the bytes, 2 per stored value: bytes-bound (qwen1.5-4b's
// W1, 254 blocks of 128 x 128, is 8.3 MB, 2.5 us at 3.35 TB/s).  The float32
// Y grows with k, so the function stays bytes-bound at every k the FFN runs,
// but its operations close in: at k = 512 they take 4.3 us at 989 TFLOP/s
// against 7.5 us of bytes, and mma.sync reaches only part of that peak.
//
// Design (bcsr_bf16_mma): the tensor-core path, taken when bm % 16 == 0 and
// bk % 16 == 0 (the FFN's (128, 128) blocks and every configuration in
// configs/).  Each product runs on the bf16 tensor cores with float32
// accumulators in registers: mma.sync m16n8k16, A (a block's rows, row-major)
// by ldmatrix, B (X, k contiguous) by ldmatrix.trans.  mma.sync and not wgmma:
// wgmma's unit is a 64-row warpgroup tile, and at decode the grid needs
// 16-row slices to fill the card (W2 has 20 block rows); the operations are
// not the bound at any k the FFN runs.
// * One CTA of four warps owns (block row, slice of RS rows, N tile of NT
//   columns), the N tiles of a slice on neighbouring CTAs.  RS = 16 for
//   k <= 32 (W2's 20 block rows give 160 CTAs), 32 or 64 for wider k.  NT
//   is 8, 16, 32, 64 or 128, so a stored block leaves DRAM once per N tile,
//   not once per 8 columns (launch_bf16_mma gives the rule).
// * The CTA walks its block row's stored blocks in stored order through a
//   ring of S stages in shared memory (cp.async; S - 1 stages in flight
//   while one is consumed, S = 8 at k <= 8, where a stage is a 4 KB slice
//   and a 1-2 KB X tile).  A stage holds the block's RS x bk slice and the
//   X tile of its column block (bk rows x NT columns), so X reaches the
//   tensor cores from shared memory.  Rows are padded by 16 bytes, so
//   ldmatrix reads without bank conflicts.  The row's block columns are
//   read into shared memory once, and each thread's copy addresses are
//   fixed for the walk (its rows and column within a stage), so a stage
//   issues its copies with no index arithmetic and no load of its own (an
//   integer division per copy made issuing cost more than the copy).
// * X is copied in 16-, 8- or 4-byte pieces where k is a multiple of 8, 4
//   or 2, and by element (a plain load and store) where k is odd, into rows
//   that ldmatrix.trans reads.  Below k = 8 a block's X rows are one
//   contiguous run of bk k values, copied whole in 16-byte pieces, and B is
//   built from it by 16-bit loads.  Only the columns j < k enter a product
//   (a column of B reaches only its own column of it), and Y is written
//   only where j < k.
// * What bounds it at decode: the walk is a chain of stages, one per stored
//   block of the row (W2's longest row holds 22), so the CTAs of the longest
//   rows set the time.  A bulk copy (TMA) per slice in place of cp.async,
//   deeper rings and eight warps a CTA were tried and moved nothing.
// * At k <= 32 the four warps split each block's 16-deep steps (warp w takes
//   steps w, w + 4, ...) and their partial sums meet in shared memory in warp
//   order; wider tiles give each warp a 16- or 32-row by 16- to 64-column
//   part of the tile.  No atomics, and no sum crosses a CTA: every output
//   is summed in a fixed order, so two launches give the same bits, and an
//   empty block row writes zeros.
//
// Other shapes (bk = 8, or bm not a multiple of 16) take bcsr_bf16, the first
// kernel of this path: CUDA cores, each value widened to float32 in
// registers.  One CTA per (block row, 8-row group, N tile of 1, 4 or 8
// columns); its eight warps split the row's stored blocks (warp w takes
// blocks w, w + 8, ...), each lane keeps the next block's 16-byte slices in
// flight, a lane's sums meet in a fixed xor-shuffle tree and the warps' sums
// in shared memory in warp order.  It takes bk in {8, 16, 32, 64, 128, 256}
// and any bm.  The launcher chooses between the two by shape alone.
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

// -- the tensor-core path ----------------------------------------------------
constexpr int kMmaThreads = 128;  // four warps a CTA
constexpr int kPad = 8;           // bf16 values of padding after each smem row
constexpr int kColCap = 256;      // a block row's columns staged in smem

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v0 at Y[row, j], v1 at Y[row, j + 1] (j even), each only where it is < k.
__device__ __forceinline__ void store_pair(float* yr, int j, int k, float v0,
                                           float v1) {
  if (j + 1 < k && (k & 1) == 0) {
    *reinterpret_cast<float2*>(yr + j) = make_float2(v0, v1);
  } else {
    if (j < k) yr[j] = v0;
    if (j + 1 < k) yr[j + 1] = v1;
  }
}

// A CTA tile of RS rows x NT columns; the four warps are WM x WN parts of it,
// each repeated over SK splits of the 16-deep steps; S ring stages.  XD: k < 8
// and one N tile of 8, so each stage copies its block's X rows whole (bk k
// values, contiguous) and builds B from them by 16-bit loads.
template <int RS, int NT, int WM, int WN, int SK, int S, bool XD = false>
struct MmaTile {
  static_assert(!XD || (NT == 8 && WN == 1), "dense X tiles take N tiles of 8");
  static_assert(WM * WN * SK == 4, "four warps a CTA");
  static constexpr int kWR = RS / WM;  // warp tile rows
  static constexpr int kWC = NT / WN;  // warp tile columns
  static constexpr int kMI = kWR / 16;
  static constexpr int kNI = kWC / 8;
  static_assert(kMI * 16 == kWR && kNI * 8 == kWC, "whole mma tiles");
  static_assert(kNI == 1 || kNI % 2 == 0, "B fragments load in pairs");
  static constexpr int kXS = NT == 8 ? 8 : NT + kPad;  // X row stride in smem
  // bf16 values of a stage for block width bk: the A slice, then the X tile.
  __host__ __device__ static int a_elems(int bk) { return RS * (bk + kPad); }
  __host__ __device__ static int stage_elems(int bk) { return a_elems(bk) + bk * kXS; }
  static size_t smem_bytes(int bk) {
    const size_t ring = (size_t)S * stage_elems(bk) * 2;
    const size_t part = SK > 1 ? (size_t)SK * RS * NT * 4 : 0;
    return ring > part ? ring : part;
  }
};

// xv: the X copy's piece in bf16 values (8, 4 or 2: cp.async of 16, 8 or 4
// bytes; 1: a plain load and store), the largest that divides k.
template <int RS, int NT, int WM, int WN, int SK, int S, bool XD>
__global__ void __launch_bounds__(kMmaThreads)
bcsr_bf16_mma(const int* __restrict__ indptr, const int* __restrict__ block_cols,
              const unsigned short* __restrict__ blocks,
              const unsigned short* __restrict__ x, float* __restrict__ y,
              int bm, int bk, int k, int n_slices, int n_tiles, int xv) {
  using T = MmaTile<RS, NT, WM, WN, SK, S, XD>;
  constexpr int MI = T::kMI, NI = T::kNI, XS = T::kXS;
  extern __shared__ uint4 smem_mma[];
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem_mma);
  const int as = bk + kPad;  // A row stride in smem
  const int a_elems = T::a_elems(bk);
  const int stage = T::stage_elems(bk);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wn = warp % WN;
  const int wm = (warp / WN) % WM;
  const int sk = warp / (WN * WM);
  const int unit = blockIdx.x / n_tiles;
  const int brow = unit / n_slices;
  const int r0 = (unit - brow * n_slices) * RS;
  const int j0 = (blockIdx.x - unit * n_tiles) * NT;
  const int g0 = indptr[brow];
  const int nb = indptr[brow + 1] - g0;
  const int ksteps = bk >> 4;
  // The row's first kColCap block columns, read once: a stage's X address
  // must not wait on a load of its own.
  __shared__ int s_cols[kColCap];
  for (int i = tid; i < min(nb, kColCap); i += kMmaThreads)
    s_cols[i] = __ldg(block_cols + g0 + i);
  __syncthreads();

  // A thread's pieces are the same in every stage: A rows a_r, a_r + a_step,
  // ... at column a_q, X rows x_r, x_r + x_step, ... at column x_q (pieces
  // per row are a power of two), so the walk computes no index but the
  // stage's base.  X pieces past k are never copied.
  const int a_pr = bk >> 3;  // 16-byte pieces per slice row
  const int a_step = kMmaThreads / a_pr;
  const int a_r = tid / a_pr;
  const int a_q = (tid % a_pr) * 8;
  const int x_pr = NT / xv;  // pieces per tile row
  const int x_step = kMmaThreads / x_pr;
  const int x_r = tid / x_pr;
  const int x_q = (tid % x_pr) * xv;
  const bool x_live = x_q < min(NT, k - j0);
  const int x_pieces = (bk * k) >> 3;  // XD: 16-byte pieces of a column block

  // Stage b of the ring: block g0 + b's slice and X tile into slot b mod S.
  auto issue = [&](int b) {
    if (b < nb) {
      unsigned short* a_dst = ring + (b % S) * stage + a_q;
      unsigned short* x_dst = ring + (b % S) * stage + a_elems + x_q;
      const int g = g0 + b;
      const unsigned short* a_src = blocks + ((long long)g * bm + r0) * bk + a_q;
      for (int r = a_r; r < RS; r += a_step) cp_async16(a_dst + r * as, a_src + r * bk);
      const int col = b < kColCap ? s_cols[b] : __ldg(block_cols + g);
      if constexpr (XD) {
        const unsigned short* src = x + (long long)col * bk * k;
        unsigned short* d = ring + (b % S) * stage + a_elems;
        for (int c = tid; c < x_pieces; c += kMmaThreads) cp_async16(d + c * 8, src + c * 8);
      }
      const unsigned short* x_src = x + (long long)col * bk * k + j0 + x_q;
      if (!XD && x_live) {
        for (int r = x_r; r < bk; r += x_step) {
          unsigned short* d = x_dst + r * XS;
          const unsigned short* src = x_src + (long long)r * k;
          if (xv == 8) cp_async16(d, src);
          else if (xv == 4) cp_async8(d, src);
          else if (xv == 2) cp_async4(d, src);
          else *d = __ldg(src);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int b = 0; b < nb; ++b) {
    cp_async_wait<S - 2>();  // this thread's copies of stage b landed
    __syncthreads();         // everyone's, and stage b - 1 is consumed
    issue(b + S - 1);        // into the slot stage b - 1 held
    const unsigned short* a_st = ring + (b % S) * stage;
    const unsigned short* x_st = a_st + a_elems;
    for (int ks = sk; ks < ksteps; ks += SK) {
      unsigned af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(af[mi], a_st + (wm * T::kWR + mi * 16 + (lane & 15)) * as + ks * 16 +
                            (lane >> 4) * 8);
      const unsigned short* xr = x_st + (ks * 16 + (lane & 15)) * XS + wn * T::kWC;
      if constexpr (XD) {
        // B[2t, 2t + 1][g] and B[2t + 8, 2t + 9][g] of the step, g < k
        const int g = lane >> 2;
        unsigned b0 = 0, b1 = 0;
        if (g < k) {
          const unsigned short* xc = x_st + (ks * 16 + (lane & 3) * 2) * k + g;
          b0 = xc[0] | (unsigned)xc[k] << 16;
          b1 = xc[8 * k] | (unsigned)xc[9 * k] << 16;
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][0], af[mi], b0, b1);
      } else if constexpr (NI == 1) {
        unsigned bf[2];
        ldsm_x2_trans(bf, xr);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][0], af[mi], bf[0], bf[1]);
      } else {
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          unsigned bf[4];
          ldsm_x4_trans(bf, xr + (ni + (lane >> 4)) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][ni], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][ni + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator e of (mi, ni): row 16 mi + lane / 4 + 8 (e / 2), column
  // 8 ni + 2 (lane % 4) + e % 2 of the warp's tile.
  const int fr = lane >> 2;
  const int fc = (lane & 3) * 2;
  if constexpr (SK == 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * T::kWR + mi * 16 + fr + 8 * h;
        float* yr = y + ((long long)brow * bm + r) * k;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          store_pair(yr, j0 + wn * T::kWC + ni * 8 + fc, k, acc[mi][ni][2 * h],
                     acc[mi][ni][2 * h + 1]);
      }
  } else {
    // The SK splits meet in shared memory (the ring is free now), summed in
    // split order.
    float* part = reinterpret_cast<float*>(smem_mma);
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::kWR + mi * 16 + fr + 8 * h;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          float* pr = part + (sk * RS + r) * NT + wn * T::kWC + ni * 8 + fc;
          pr[0] = acc[mi][ni][2 * h];
          pr[1] = acc[mi][ni][2 * h + 1];
        }
      }
    __syncthreads();
    for (int e = tid; e < RS * NT; e += kMmaThreads) {
      const int r = e / NT;
      const int j = j0 + (e - r * NT);
      if (j >= k) continue;
      float s = part[e];
#pragma unroll
      for (int w = 1; w < SK; ++w) s += part[w * RS * NT + e];
      y[((long long)brow * bm + r0 + r) * k + j] = s;
    }
  }
}

template <int RS, int NT, int WM, int WN, int SK, int S, bool XD = false>
int launch_mma(const int* indptr, const int* block_cols,
               const unsigned short* blocks, const unsigned short* x, float* y,
               int gm, int bm, int bk, int k, cudaStream_t s) {
  using T = MmaTile<RS, NT, WM, WN, SK, S, XD>;
  auto kernel = bcsr_bf16_mma<RS, NT, WM, WN, SK, S, XD>;
  const int n_slices = bm / RS;
  const int n_tiles = (k + NT - 1) / NT;
  const long long nb = (long long)gm * n_slices * n_tiles;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int xv = k % 8 == 0 ? 8 : k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1;
  const size_t smem = T::smem_bytes(bk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)nb, kMmaThreads, smem, s>>>(indptr, block_cols, blocks, x, y,
                                                 bm, bk, k, n_slices, n_tiles, xv);
  return (int)cudaGetLastError();
}

// The tile for k: 16-row slices and N tiles of 8, 16 or 32 up to k = 32
// (dense X rows below k = 8); past it 32-row slices and N tiles of 64, or
// 64 x 128 tiles where the grid still has two CTAs for each of the H100's
// 132 SMs (16 x 64 where bm is not a multiple of 32).  bm % 16 == 0 and
// bk % 16 == 0 (bk <= 256: a stage fits).
int launch_bf16_mma(const int* indptr, const int* block_cols,
                    const unsigned short* blocks, const unsigned short* x,
                    float* y, int gm, int bm, int bk, int k, cudaStream_t s) {
#define BF16_MMA(RS, NT, WM, WN, SK, S) \
  launch_mma<RS, NT, WM, WN, SK, S>(indptr, block_cols, blocks, x, y, gm, bm, bk, k, s)
  if (k < 8)
    return launch_mma<16, 8, 1, 1, 4, 8, true>(indptr, block_cols, blocks, x, y, gm, bm,
                                              bk, k, s);
  if (k == 8) return BF16_MMA(16, 8, 1, 1, 4, 8);
  if (k <= 16) return BF16_MMA(16, 16, 1, 1, 4, 6);
  if (k <= 32) return BF16_MMA(16, 32, 1, 1, 4, 4);
  if (bm % 32) return BF16_MMA(16, 64, 1, 4, 1, 3);
  const long long ctas64 = (long long)gm * (bm / 64) * ((k + 127) / 128);
  if (k > 64 && bm % 64 == 0 && ctas64 >= 2 * 132) return BF16_MMA(64, 128, 2, 2, 1, 2);
  return BF16_MMA(32, 64, 2, 2, 1, 4);
#undef BF16_MMA
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
// The tensor-core path takes bm % 16 == 0 and bk % 16 == 0, bcsr_bf16 the
// rest (the wrapper's bf16_tensor_core_path mirrors the rule).
extern "C" int bcsr_spmm_bf16_launch(const int* indptr, const int* block_cols,
                                     const unsigned short* blocks,
                                     const unsigned short* x, float* y, int gm,
                                     int bm, int bk, int k, void* stream) {
  if (gm <= 0 || k <= 0) return 0;
  if (bm < 1) return (int)cudaErrorInvalidValue;
  const int n_rg = (bm + 7) / 8;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm % 16 == 0 && bk % 16 == 0 && bk <= 256)
    return launch_bf16_mma(indptr, block_cols, blocks, x, y, gm, bm, bk, k, s);
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
