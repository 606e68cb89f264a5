// BCSR SpMM on Hopper: Y[r*bm + i, j] = sum over the stored blocks g of block
// row r, sum_t blocks[g, i, t] * X[block_cols[g]*bk + t, j].
//
// Replaces the TPU kernel src/repro/kernels/bcsr_spmm.py::bcsr_spmm_pallas.
//
// Bound: device-memory bytes at the serving widths k in {1, 4, 16, 64}: a
// stored block is 4*bm*bk bytes for 2*bm*bk*k flops, and X and Y add 4*k
// bytes per row; only at k = 64 does the float32 FMA time (no tensor cores)
// come near the memory time, and chip_smoke.py reports both.
//
// Design: the TPU kernel walks the row-sorted block stream and revisits a
// VMEM-resident Y strip; here a block-row pointer (indptr, built at prepare
// time) lets each output element be owned by one thread, which walks its
// block row's blocks in stored order, accumulates in float32 FMA and writes
// once: no atomics, deterministic, and empty block rows write zeros.  One CUDA
// block covers rows_per_cta block rows x an N tile of bn <= 64 columns, so a
// block's A elements are read once per N tile and broadcast across the bn
// threads of a row; neighbouring threads read neighbouring X columns.  Tensor
// cores (TF32 would change the numerics) and wgmma-sized row stacking are
// left to a later change.
#include <cuda_runtime.h>

namespace {

__global__ void bcsr_spmm_kernel(const int* __restrict__ indptr,
                                 const int* __restrict__ block_cols,
                                 const float* __restrict__ blocks,
                                 const float* __restrict__ x,
                                 float* __restrict__ y, int gm, int bm, int bk,
                                 int k, int bn, int rows_per_cta) {
  const int per_row = bm * bn;
  const int rr = threadIdx.x / per_row;
  if (rr >= rows_per_cta) return;
  const long long brow = (long long)blockIdx.x * rows_per_cta + rr;
  if (brow >= gm) return;
  const int e = threadIdx.x - rr * per_row;
  const int i = e / bn;
  const int j = blockIdx.y * bn + (e - i * bn);
  if (j >= k) return;
  float acc = 0.f;
  const int g1 = indptr[brow + 1];
  for (int g = indptr[brow]; g < g1; ++g) {
    const float* a = blocks + ((long long)g * bm + i) * bk;
    const float* xb = x + (long long)__ldg(block_cols + g) * bk * k + j;
    for (int t = 0; t < bk; ++t) {
      acc = fmaf(__ldg(a + t), __ldg(xb + (long long)t * k), acc);
    }
  }
  y[(brow * bm + i) * (long long)k + j] = acc;
}

}  // namespace

extern "C" int bcsr_spmm_launch(const int* indptr, const int* block_cols,
                                const float* blocks, const float* x, float* y,
                                int gm, int bm, int bk, int k, void* stream) {
  if (gm <= 0 || k <= 0) return 0;
  if (bm < 1 || bk < 1) return (int)cudaErrorInvalidValue;
  const int bn = k < 64 ? k : 64;
  const int per_row = bm * bn;
  if (per_row > 1024) return (int)cudaErrorInvalidConfiguration;
  const int threads = per_row >= 256 ? per_row : (256 / per_row) * per_row;
  const int rows_per_cta = threads / per_row;
  const dim3 grid((unsigned)((gm + rows_per_cta - 1) / rows_per_cta),
                  (unsigned)((k + bn - 1) / bn));
  bcsr_spmm_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      indptr, block_cols, blocks, x, y, gm, bm, bk, k, bn, rows_per_cta);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
