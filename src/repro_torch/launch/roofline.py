"""Roofline analysis over the dry run's JSONs (``launch.dryrun``), for one
NVIDIA H100 SXM a card.  The port's counterpart of the JAX package's
``launch.roofline``.

Per (arch x shape x mesh) cell, from the busiest card's figures:

  compute term    = flops_per_device / PEAK_FLOPS
  memory term     = hbm_bytes_per_device / HBM_BW
  collective term = collective_bytes_per_device / LINK_BW

All three in seconds a step; the largest is the bottleneck and the step's
lower bound.  ``model_flops`` uses the 6ND convention (dense train), 2ND
for a forward pass (prefill) and 2NB for a decode step, with N_active for
MoE; its ratio against the analyzed FLOPs exposes remat recompute,
attention and the eager path's elementwise work.

Usage:
  python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]
                                        [--tag baseline] [--md roofline.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.models.lm import init_model

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CHIPS", "param_counts", "model_flops",
           "terms", "load", "remedy", "remedy_branch", "render_md", "main"]

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s, H100 SXM datasheet
HBM_BW = 3.35e12  # B/s of HBM3, H100 SXM datasheet
LINK_BW = 50e9  # B/s: one card's inter-node link, NDR InfiniBand at 400 Gb/s

CHIPS = {"16x16": 256, "2x16x16": 512}


def param_counts(arch: str, reduced: bool = False) -> tuple[int, int]:
    """(total, active) parameter counts of the full configuration (or the
    reduced one), from ``init_model(cfg, device="meta")``: every entry of
    the model's state; a MoE model counts top_k / n_experts of its
    experts' weights (the router whole) as active."""
    cfg = (get_reduced if reduced else get_config)(arch)
    state = init_model(cfg, device="meta").state_dict()
    total = sum(t.numel() for t in state.values())
    active = total
    if cfg.moe is not None:
        moe_total = sum(t.numel() for name, t in state.items()
                        if ".ffn." in name and name.startswith("blocks.")
                        and not name.endswith(".router"))
        active = total - moe_total + moe_total * cfg.moe.top_k // cfg.moe.n_experts
    return total, active


def model_flops(arch: str, shape_name: str, reduced: bool = False) -> float:
    """6*N_active*D (train), 2*N_active*D (prefill), 2*N_active*B (decode)."""
    sh = SHAPES[shape_name]
    _, active = param_counts(arch, reduced)
    if sh.kind == "train":
        return 6.0 * active * sh.batch * sh.seq
    if sh.kind == "prefill":
        return 2.0 * active * sh.batch * sh.seq
    return 2.0 * active * sh.batch  # decode: one token per sequence


def terms(rec: dict) -> dict:
    chips = CHIPS[rec["mesh"]]
    pd = rec["per_device"]
    t_comp = pd["flops"] / PEAK_FLOPS
    t_mem = pd["hbm_bytes"] / HBM_BW
    t_coll = pd["collective_bytes"] / LINK_BW
    bound = max(
        ("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(rec["arch"], rec["shape"], rec.get("reduced", False)) / chips
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "bottleneck": bound,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": mf / pd["flops"] if pd["flops"] else 0.0,
        # the step if its terms overlapped perfectly = the largest term;
        # MFU bound = model FLOPs at peak over that step
        "step_s_lower_bound": max(t_comp, t_mem, t_coll),
        "mfu_upper_bound": mf / PEAK_FLOPS / max(t_comp, t_mem, t_coll),
    }


def load(dirname: str, tag: str | None):
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if tag and r.get("tag") != tag:
            continue
        recs.append(r)
    return recs


def remedy_branch(rec: dict, t: dict) -> str:
    """Which term dominates and why: ``moe``, the dominant collective's
    kind, ``decode``, ``memory`` or ``compute``."""
    coll = rec["per_device"].get("collectives", {})
    top_coll = max(coll, key=coll.get) if coll else "none"
    if t["bottleneck"] == "collective":
        moe = "moe" in rec["arch"] or "scout" in rec["arch"]
        return "moe" if moe else top_coll
    if t["bottleneck"] == "memory":
        decode = rec["shape"].startswith("decode") or rec["shape"] == "long_500k"
        return "decode" if decode else "memory"
    return "compute"


REMEDIES = {
    "moe": "each replica gathers every expert's weights whole: an expert split over "
           "'model' with tensor-parallel compute (ROADMAP A.14) keeps them on their owners",
    "gather": "each replica gathers the whole weights every step (storage sharding): "
              "A.14's tensor-parallel split of the projections gathers none",
    "reduce": "every replica's whole gradient goes to the owners: A.14's tensor-parallel "
              "split reduces only each shard's share",
    "state_gather": "the decode state is stored split over 'model' but computed on whole "
                    "rows: A.14's tensor-parallel attention reads the slots where they live",
    "decode": "k=1 regime: the weights and the KV cache stream once a token; a larger batch "
              "(SpMM amortization, Fig 9) raises the FLOPs a byte",
    "memory": "eager elementwise bytes dominate: fusing the elementwise chain (norms, RoPE, "
              "softmax and masks, SiLU, residual adds, casts; ROADMAP A.6) cuts them",
    "compute": "compute-bound: bf16 tensor-core matmuls; the block-sparse FFN "
               "(sparse_ffn=bcsr) cuts the FFN's FLOPs",
}


def remedy(rec: dict, t: dict) -> str:
    """One sentence: what in the port's design moves the dominant term."""
    branch = remedy_branch(rec, t)
    return REMEDIES.get(branch, f"dominant {branch}: overlap it with compute")


def render_md(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "bottleneck | 6ND/ops | MFU bound | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — | — | — | "
                f"SKIP: {r['reason']} |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — | — | — | "
                f"ERROR: {r.get('error', '')[:80]} |"
            )
            continue
        t = terms(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['t_compute_s']:.3e} | {t['t_memory_s']:.3e} "
            f"| {t['t_collective_s']:.3e} | **{t['bottleneck']}** "
            f"| {t['useful_flops_ratio']:.2f} | {t['mfu_upper_bound']:.2%} "
            f"| {remedy(r, t)} |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Roofline table of the dry run's cells "
                                             "(H100 SXM figures)")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    recs = load(args.dir, args.tag)
    md = render_md(recs)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
