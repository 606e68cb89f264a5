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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
