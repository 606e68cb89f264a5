"""The paper's own workload: the 22-matrix SpMV/SpMM suite (Table 1).

Not a ModelConfig — this config drives the benchmark harness and the
sparse-kernel examples: which matrices, at what scale, which formats,
which k widths (the paper uses k=16 for SpMM, Fig 9).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SparseSuiteConfig:
    scale: float = 1.0 / 16  # fraction of Table 1 row counts (CPU container)
    seed: int = 0
    spmm_k: int = 16  # paper Fig 9
    sell_C: int = 8
    sell_sigma: int = 64
    bcsr_blocks: tuple = ((8, 128), (16, 128), (128, 128))
    formats: tuple = ("csr", "sell", "bcsr")


CONFIG = SparseSuiteConfig()
SMALL = SparseSuiteConfig(scale=1.0 / 64)
