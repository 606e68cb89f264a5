"""Find the highest rate an open-loop cell's traffic is served at, once, on
the card: one set-up, then one window at each rate given.

    python3 bench/sweep.py --workload ldoor.stream --seed 5 --seconds 10 \\
        --rates 2000,4000,8000

For each rate it prints the offered and served req/s, their ratio, the
backlog (requests due and not answered) after the first second and at the
window's end, and p50 / p95 latency from due.  The knee is the highest rate
served within 1 % of the offered rate whose backlog at the end is no longer
than after the first second; the cell's traffic file then carries 0.8 x
the knee as a fixed number.
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
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True, help="comma-separated req/s")
    args = p.parse_args()
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(ROOT / "bench" / ".cache" / "plans.json")

    import torch

    from benchkit import cell as cellmod, spec
    from benchkit.traffic import schedule

    c = spec.find_cell(ROOT, args.workload)
    if "rate_per_s" not in c.traffic or not torch.cuda.is_available():
        print("the sweep needs an open-loop cell and a card", file=sys.stderr)
        return 2
    run = cellmod.Run(c, args.seed, "cuda", T_START, warm=tuple(c.traffic["warm"]))
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        sched = schedule(dict(c.traffic, rate_per_s=rate), args.seed, args.seconds)
        ctx = run.window(sched, args.seconds, False)
        served = ctx.completed / ctx.window_s
        offered = sched.due_s.shape[0] / args.seconds
        row = {"rate": rate, "offered": offered, "served": served,
               "served_share": served / offered, "backlog_1s": ctx.backlog[0],
               "backlog_end": ctx.backlog[1],
               "p50_ms": cellmod.percentile(ctx.latencies_ms, 50),
               "p95_ms": cellmod.percentile(ctx.latencies_ms, 95),
               "batch_width": ctx.occupied_cols / max(ctx.dispatches, 1)}
        row["sustained"] = (row["served_share"] >= 0.99
                            and ctx.backlog[1] <= ctx.backlog[0])
        rows.append(row)
        print(json.dumps(row), flush=True)
    checks, _ = run.check()
    print(json.dumps({"sweep": rows, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
