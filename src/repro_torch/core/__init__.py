"""Core sparse-matrix library: formats, metrics, reordering and the plain
torch SpMV/SpMM tiers — the JAX package's ``repro.core`` facade, name for
name, each name the port's own counterpart."""
from .formats import (  # noqa: F401
    BCSRMatrix,
    CSRMatrix,
    SELLMatrix,
    bcsr_from_csr,
    bcsr_to_dense,
    csr_from_coo,
    csr_from_dense,
    csr_to_dense,
    sell_from_csr,
    sell_to_dense,
)
from .metrics import (  # noqa: F401
    flop_to_byte_spmm,
    flop_to_byte_spmv,
    matrix_bandwidth,
    spmm_app_bytes,
    spmv_app_bytes,
    spmv_naive_bytes,
    ucld,
    ucld_per_row,
    utd,
)
from .reorder import degree_order, random_order, rcm  # noqa: F401
from .spmv import (  # noqa: F401
    spd_shift,
    spmm,
    spmm_bcsr_dense,
    spmm_csr,
    spmm_sell,
    spmv,
    spmv_csr,
    spmv_csr_scalar,
    spmv_sell,
    symmetrize,
)
