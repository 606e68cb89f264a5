"""Mesh-aware training launcher: the JAX package's ``launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --reduced --steps 20 --markov [--device cpu] [--data 2 --model 4]

Trains ``--arch`` (full width, or ``--reduced``) from seed 0 with
``train_loop``: AdamW (``--lr`` peak, a warmup of steps // 20, cosine to
``--steps``, ``--moment-dtype`` f32 or bf16), ``--batch`` x ``--seq``
tokens a step (iid, or ``--markov``: a learnable Markov chain), split into
``--microbatches``, checkpoints every ``--ckpt-every`` steps under
``--ckpt-dir`` (a run resumes from the latest one there).  It prints each
log line and, last, one JSON summary: steps run, the median step ms
(steps after the first), tokens/s at that median, first and last loss,
the mesh's shape and distinct device count, and the allocator's peak
bytes on the (first) card (null on the CPU).

``--device`` is ``cuda`` (the default; raises without a card) or ``cpu``.
``--pods`` x ``--data`` x ``--model`` above 1 trains on
``make_mesh(pods, data, model)`` with ``default_rules(multi_pod=pods >
1)``: any factorization, its cells round-robin on the visible cards (on
one card all of them share it; on ``cpu`` all are the CPU).  Checkpoints
hold the logical layout, so a run resumes on another factorization.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.device import resolve
from repro_torch.data.pipeline import MarkovTokens, SyntheticTokens
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import default_rules
from repro_torch.optim.adamw import OptimConfig
from repro_torch.runtime.trainer import TrainConfig, train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moment-dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--markov", action="store_true",
                    help="learnable Markov-chain data instead of iid tokens")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    n_cells = args.pods * args.data * args.model
    mesh = (make_mesh(args.pods, args.data, args.model, device=dev)
            if n_cells > 1 else None)
    rules = default_rules(multi_pod=args.pods > 1)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    gen_cls = MarkovTokens if args.markov else SyntheticTokens
    data = gen_cls(vocab=cfg.vocab, batch=args.batch, seq=args.seq, seed=0)
    opt = OptimConfig(
        lr_peak=args.lr,
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        moment_dtype=torch.bfloat16 if args.moment_dtype == "bf16" else torch.float32,
    )
    tc = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                     ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, _, hist = train_loop(cfg, opt, tc, data, mesh=mesh, rules=rules, device=dev,
                            log=lambda line: print(line, flush=True))
    times = [h["time_s"] for h in hist[1:]] or [h["time_s"] for h in hist]
    step_ms = float(np.median(times)) * 1e3 if times else None
    summary = {
        "arch": cfg.arch_id,
        "device": str(dev),
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "n_devices": mesh.n_devices if mesh is not None else 1,
        "steps": len(hist),
        "tokens_per_step": args.batch * args.seq,
        "step_ms": step_ms,
        "tokens_per_s": args.batch * args.seq / (step_ms / 1e3) if step_ms else None,
        "first_loss": hist[0]["loss"] if hist else None,
        "last_loss": hist[-1]["loss"] if hist else None,
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
