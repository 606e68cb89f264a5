"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

sell_spmv -- SELL-C-sigma SpMV and its column-slab variant;
bcsr_spmm -- BCSR SpMM; spmspv -- the sparse-RHS tier (stream-ordered);
ops -- prepare + dispatch; ref -- plain oracles;
_build -- nvcc build at first use, ctypes binding, launch counts.

As ``repro.kernels`` does, the package exports ``merge_spmv``, ``ops`` and
``ref``, and beside them the four kernel wrappers under their own names:
``sell_spmv``, ``sell_spmv_blocked``, ``bcsr_spmm``, ``spmspv_scatter``.
Two share their module's name, so the attributes ``kernels.sell_spmv`` and
``kernels.bcsr_spmm`` are the functions; reach the modules by importing
from them (``from repro_torch.kernels.bcsr_spmm import bcsr_spmm_plain``).
The JAX package's ``*_pallas`` names and ``slab_pipeline`` have no
counterpart (ROADMAP A, "Left out on purpose").
"""
from . import merge_spmv, ops, ref  # noqa: F401
from .bcsr_spmm import bcsr_spmm  # noqa: F401
from .sell_spmv import sell_spmv, sell_spmv_blocked  # noqa: F401
from .spmspv import spmspv_scatter  # noqa: F401
