"""Find the highest rate a live cell's configuration sustains, once, on
the card: the rate its traffic file then offers a fraction of.

    python3 cmax_bench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> [--fractions 0.7,0.8,0.9,1.0,1.1 | --rates a,b,...]

First the cell's streams and windows as a closed loop with a full
backlog (every stream 2 windows ahead): its windows per second is the
capacity C. Then the cell's open loop at each fraction of C. Prints one
JSON line per point: the offered and answered rates, the latency median
and 95th percentile, and the windows still unanswered at the close (a
backlog that grows through the window means the rate is not sustained).
No reference check runs here.
"""
import copy
import json
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cmax_bench import harness, spec  # noqa: E402


def point(cell, seed, seconds, **traffic):
    c = copy.deepcopy(cell)
    c.traffic.update(traffic)
    out = harness.run(c, seed, seconds, False, t_process=time.perf_counter(),
                      judge=False)
    e2e = out["end_to_end"]
    return {"loop": c.traffic["loop"],
            "offered_per_s": c.traffic.get("rate_per_s"),
            "windows_per_s": e2e["windows_per_s"],
            "latency_p50_ms": e2e["latency_p50_ms"],
            "latency_p95_ms": e2e["latency_p95_ms"],
            "due": out["attempted"], "open_at_close": out["open_at_close"]}


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fractions", default="0.7,0.8,0.9,1.0,1.1")
    ap.add_argument("--rates", default="",
                    help="offered windows/s to try instead of fractions of "
                         "the closed loop's capacity (which is then not "
                         "measured)")
    args = ap.parse_args(argv)
    harness.cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.rates:
        rates = [float(x) for x in args.rates.split(",")]
    else:
        cap = point(cell, args.seed, args.seconds, loop="closed",
                    outstanding=2)
        print(json.dumps(cap), flush=True)
        rates = [float(f) * cap["windows_per_s"]
                 for f in args.fractions.split(",")]
    for r in rates:
        print(json.dumps(point(cell, args.seed, args.seconds,
                               rate_per_s=r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
