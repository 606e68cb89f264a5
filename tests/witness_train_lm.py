"""The example's training run, ``repro``'s ``train_loop`` beside the port's
(``examples/train_lm_torch.py``), on the CPU: the same initial weights
(``repro``'s ``init_model`` carried by ``interop.lm_params_from_numpy``),
the same ``MarkovTokens`` stream and the example's schedule (lr 6e-4, 20
warmup steps, cosine to 0 over the run, 2 microbatches).  Both loss curves,
their first-5 and last-20 means and the largest per-step gap are printed
and, with ``--out``, written as JSON.

``tests/test_torch_examples.py`` calls :func:`curves` at a tiny size; run
at the example's width to see how far the schedule takes the loss:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_train_lm.py \\
        --steps 300 --layers 2 --out witness.json

(``--layers 2``: ``--big``'s width, vocabulary, batch and sequence, its
depth cut from 12 to 2 for the CPU; ``--layers 12 --narrow``: its depth
at the example's small width, d 384.)
"""
import argparse
import importlib.util
import json
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.data.pipeline import MarkovTokens as JMarkovTokens
from repro.models import lm as jlm
from repro.optim import adamw as ja
from repro.runtime import trainer as jt

from repro_torch.interop import lm_params_from_numpy
from repro_torch.runtime import trainer as tt

ROOT = Path(__file__).resolve().parents[1]
BIG_DIMS = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                vocab=8192)
NARROW = dict(d_model=384, n_heads=6, n_kv_heads=2, d_ff=1024)  # the example's small width


def load_twin():
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("example_train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def curves(dims: dict, steps: int, batch: int, seq: int, ckpt_root) -> dict:
    """Both runs' per-step losses over ``steps`` steps of the example's
    schedule at ``dims``, batch ``batch`` x ``seq`` tokens."""
    mod = load_twin()
    mod.SMALL_DIMS, mod.BATCH, mod.SEQ = dict(dims), batch, seq
    jcfg = jlm.ModelConfig(arch_id="example-lm", family="dense", dtype=jnp.float32,
                           remat="none", attn_chunk=128, sparse_ffn=None, **dims)
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, 0)[0])
    init = tt.init_model
    tt.init_model = lambda cfg, seed, device: lm_params_from_numpy(jcfg, params,
                                                                   device=device)
    try:
        t0 = time.perf_counter()
        out = mod.main(["--steps", str(steps), "--device", "cpu",
                        "--ckpt-dir", str(Path(ckpt_root) / "port")])
        port_s = time.perf_counter() - t0
    finally:
        tt.init_model = init
    t0 = time.perf_counter()
    _, _, jhist = jt.train_loop(
        jcfg, ja.OptimConfig(lr_peak=6e-4, warmup_steps=20, total_steps=steps),
        jt.TrainConfig(steps=steps, microbatches=2, ckpt_every=50,
                       ckpt_dir=str(Path(ckpt_root) / "ref"), log_every=10),
        JMarkovTokens(vocab=dims["vocab"], batch=batch, seq=seq, branch=8, seed=0),
        log=lambda s: None)
    ref_s = time.perf_counter() - t0
    port = [float(h["loss"]) for h in out["history"]]
    ref = [float(h["loss"]) for h in jhist]
    rel = [abs(p - r) / abs(r) for p, r in zip(port, ref)]
    return {"dims": dims, "steps": steps, "batch": batch, "seq": seq,
            "port": port, "repro": ref, "max_rel": max(rel),
            "max_rel_step": int(np.argmax(rel)),
            "first5": {"port": float(np.mean(port[:5])), "repro": float(np.mean(ref[:5]))},
            "last20": {"port": float(np.mean(port[-20:])), "repro": float(np.mean(ref[-20:]))},
            "entropy_floor": out["entropy_floor"],
            "log_vocab": float(np.log(dims["vocab"])),
            "seconds": {"port": port_s, "repro": ref_s}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=2, help="--big's depth cut to this")
    ap.add_argument("--narrow", action="store_true",
                    help="the example's small width (d 384) at --big's vocabulary")
    ap.add_argument("--out", default=None, help="write both curves here as JSON")
    args = ap.parse_args(argv)
    dims = dict(BIG_DIMS, n_layers=args.layers, **(NARROW if args.narrow else {}))
    with tempfile.TemporaryDirectory(prefix="witness_train_lm_") as tmp:
        res = curves(dims, args.steps, 8, 256, tmp)
    for name in ("repro", "port"):
        c = res[name]
        print(f"{name}: " + " ".join(f"{s}:{c[s]:.4f}" for s in range(0, len(c), 10))
              + f" {len(c) - 1}:{c[-1]:.4f}")
    print(f"first-5 mean repro {res['first5']['repro']:.4f} port {res['first5']['port']:.4f}; "
          f"last-20 mean repro {res['last20']['repro']:.4f} port {res['last20']['port']:.4f}; "
          f"drop repro {res['first5']['repro'] - res['last20']['repro']:.4f} "
          f"port {res['first5']['port'] - res['last20']['port']:.4f}; "
          f"largest per-step gap {res['max_rel']:.3e} relative (step {res['max_rel_step']}); "
          f"log V {res['log_vocab']:.4f}, entropy floor {res['entropy_floor']:.4f}; "
          f"{res['seconds']['repro']:.0f} s / {res['seconds']['port']:.0f} s")
    if args.out:
        Path(args.out).write_text(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
