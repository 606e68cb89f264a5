"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload ldoor.batch64 --seed 7 --seconds 20 --trace 0

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``bench/configs/``), traffic mix (``bench/traffic/``) and
metrics (``bench/metrics/``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit, which also end standard error.  Without a card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]


def main(argv=None, *, device=None, scale=None, cache=None) -> int:
    """One run; ``device``, ``scale`` and ``cache`` are for the tests, which
    skip the look for a card and run a cell small on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dir = ROOT / "bench" / ".cache"
    # The program's plan cache, and Triton's should a later kernel use it,
    # at fixed paths inside the checkout: a cell's first run searches and
    # builds, later ones load.  (nvcc's builds already land in the
    # checkout, under src/repro_torch/kernels/build/.)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(cache_dir / "plans.json")
    os.environ["TRITON_CACHE_DIR"] = str(cache_dir / "triton")

    import torch

    from benchkit import cell as cellmod, guard, spec

    c = spec.find_cell(ROOT, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
            print(f"{args.workload} needs {c.chips} CUDA device(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    out = cellmod.run(c, args.seed, args.seconds, bool(args.trace), device, T_START,
                      scale=scale, cache=cache)
    result = cellmod.result(c, out, bool(args.trace))
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']!r} (limit {chk['limit']!r})", file=sys.stderr)
    # Last, once every metric's reader has run: nothing the run loaded may
    # be JAX or the JAX package.
    found = guard.loaded_forbidden()
    if found:
        print(f"modules of {found} are loaded in the benchmark's process; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
