"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

sell_spmv -- SELL-C-sigma SpMV and its column-slab variant;
bcsr_spmm -- BCSR SpMM; spmspv -- the sparse-RHS tier and its scatter;
ops -- prepare + dispatch; ref -- plain oracles;
_build -- nvcc build at first use, ctypes binding, launch counts.
"""
