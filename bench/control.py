"""The control of a cell's comparison, on the card at the cell's own size:
a whole run of the cell (set-up, a short window at the cell's own load,
the check) with the reference one precision below the configuration's
planted in the program's place, where each batch's answers are produced
(``benchkit.plant``).  The benchmark's own runs do not run it.

    python3 bench/control.py --workload ldoor.batch64 --seeds 11,12,13 --seconds 5

For each seed it prints ``correct`` and each number compared beside its
limit.  A sound control reads ``correct`` false, far above the limit
(PERF.md gives the readings).  ``--plant`` plants one of the faults
instead.
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--plant", default="control")
    args = p.parse_args()
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(ROOT / "bench" / ".cache" / "plans.json")

    import torch

    from benchkit import cell as cellmod, plant, spec

    c = spec.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 2
    ref = spec.reference(ROOT, c.config["reference"])
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        with plant.planted(args.plant, ref):
            out = cellmod.run(c, seed, args.seconds, False, "cuda", t0)
        print(json.dumps({"workload": c.name, "plant": args.plant, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "plans": out["plans"], "checks": out["checks"]}), flush=True)
        del out
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
