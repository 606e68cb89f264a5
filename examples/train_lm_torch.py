"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param LM for a
few hundred steps.

Uses the port's full stack — config, data pipeline, AdamW + cosine,
microbatch grad accumulation, async checkpointing, fault-tolerant driver —
on a small model by default (~14M params; pass --big for the ~100M
config).  The FFN can be the paper-integrated structured block-sparse
layer (--sparse), which trains as plain torch: no CUDA kernel has a
backward (ROADMAP C.29).

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.data.pipeline import MarkovTokens
from repro_torch.models.ffn import SparseFFNConfig
from repro_torch.models.lm import ModelConfig
from repro_torch.optim import OptimConfig
from repro_torch.runtime.trainer import TrainConfig, train_loop

BIG_DIMS = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                vocab=8192)  # ~100M
SMALL_DIMS = dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, d_ff=1024,
                  vocab=4096)  # ~14M — minutes on a CPU
BATCH, SEQ = 8, 256


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--sparse", action="store_true", help="block-sparse FFN")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dims = BIG_DIMS if args.big else SMALL_DIMS
    cfg = ModelConfig(
        arch_id="example-lm", family="dense", dtype=torch.float32,
        remat="none", attn_chunk=128,
        sparse_ffn=SparseFFNConfig(kind="structured", n_groups=8, band=1)
        if args.sparse else None,
        **dims,
    )
    data = MarkovTokens(vocab=dims["vocab"], batch=BATCH, seq=SEQ, branch=8, seed=0)
    opt = OptimConfig(lr_peak=6e-4, warmup_steps=20, total_steps=args.steps)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_lm_")
    tc = TrainConfig(steps=args.steps, microbatches=2, ckpt_every=50,
                     ckpt_dir=ckpt, log_every=10)
    model, opt_state, hist = train_loop(cfg, opt, tc, data, device=args.device)
    print(f"\nfinal loss {hist[-1]['loss']:.4f} "
          f"(chain entropy floor {data.entropy_floor():.4f}, "
          f"log-vocab {float(np.log(dims['vocab'])):.4f})")
    print(f"checkpoints in {ckpt}")
    return {"cfg": cfg, "opt": opt, "train": tc, "data": data, "model": model,
            "opt_state": opt_state, "history": hist, "ckpt_dir": ckpt,
            "entropy_floor": data.entropy_floor()}


if __name__ == "__main__":
    main()
