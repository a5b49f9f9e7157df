"""Read the check's numbers for the program and for its control on the
card, at a cell's own size and load, in one process:

    python3 cmax_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <a,b,...> --control-seeds <x,y,z> \\
        [--pools <p,q,...>] [--control-pools <p,q,...>]

The control is the plain reference computed in bfloat16 (votes, images,
blur and sums; `reference/cmax.py`) put in the program's place, as the
batch function the service dispatches. Each run prints one JSON line with
the numbers compared; the limits in the configuration file are set from
the largest reading of the program and the smallest of the control.
`--pools` and `--control-pools` read each side's seeds on the recordings
of other pools than the mix's own (`pool_seed`), so that the limits hold
for other data, not only for other arrangements of one pool.
Runs no part of the benchmark's own runs.
"""
import copy
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cmax_bench import harness, spec  # noqa: E402
from cmax_bench.reference import cmax as ref  # noqa: E402


def control(cell):
    """The batch function replaced by the reference in bfloat16."""
    import torch
    sched = ref.Schedule.from_config(cell.config)

    def wrap(fn):
        def f(w, o):
            t_ref = torch.where(w.valid, w.t, torch.inf).amin(1, keepdim=True)
            om, it = ref.estimate((w.x, w.y, w.t - t_ref, w.p, w.valid), o,
                                  sched, torch.bfloat16)
            return types.SimpleNamespace(omega=om, stages=[
                types.SimpleNamespace(iters=it[:, s].to(torch.int32))
                for s in range(it.shape[1])])
        return f
    return wrap


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--pools", default="")
    ap.add_argument("--control-pools", default="")
    args = ap.parse_args(argv)
    harness.cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]
    own = [cell.traffic["pool_seed"]]
    for side, breaker, todo, pools in (
            ("program", None, ints(args.seeds), ints(args.pools) or own),
            ("control", control(cell), ints(args.control_seeds),
             ints(args.control_pools) or own)):
        for pool in pools:
            c = copy.deepcopy(cell)
            c.traffic["pool_seed"] = pool
            for seed in todo:
                out = harness.run(c, seed, args.seconds, False,
                                  t_process=time.perf_counter(),
                                  breaker=breaker)
                print(json.dumps({
                    "side": side, "pool": pool, "seed": seed,
                    "correct": out["correct"],
                    "answered": out["attempted"] - out["failed"],
                    "numbers": {k: v["value"]
                                for k, v in out["compared"].items()}}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
