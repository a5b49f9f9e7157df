"""The float64 witness behind the check's served chain, on the card:

    python3 cmax_bench/witness.py --workload <cell> --seconds <s> \\
        --seeds <a,b,...> --positions <P>

Runs the cell at each seed (no reference check) and takes the first P
windows every stream answered: one pass over its recording, warm-started
from the IMU hint and then from the stream's previous answer. On the same
host windows and IMU hints, the plain reference then works out its own
chain twice, in float32 and in float64, for every stream of every seed
at once. Prints one JSON line: over all windows, the median, the 90th
percentile and the share over 1e-3 rad/s of the largest |gap| component
between each two of the port's chain, the float32 chain and the float64
chain; the same by position along the chain; and, for the port's served
windows, the gap of the port and of the float32 reference to the float64
reference from the same warm start. Runs no part of the benchmark's own
runs.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cmax_bench import check, harness, spec  # noqa: E402
from cmax_bench.reference import cmax as ref  # noqa: E402


def gap(a, b):
    import numpy as np
    return np.max(np.abs(np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)), axis=-1)


def summary(g):
    import numpy as np
    g = np.asarray(g).ravel()
    return {"median": float(np.median(g)),
            "p90": float(np.quantile(g, 0.9)),
            "share_over_1e-3": float(np.mean(g > 1e-3)), "n": int(g.size)}


def own_chain(lanes, positions, schedule, device, dtype):
    """(lanes, positions, 3): the reference's answers along each lane's
    recording, window k warm-started from its own answer to window k-1."""
    import numpy as np
    import torch
    out = np.zeros((len(lanes), positions, 3))
    omega = torch.as_tensor(np.stack([st.imu0[s] for st, s in lanes]),
                            device=device)
    for k in range(positions):
        ev = check.events_of([st.window(s, k) for st, s in lanes], device,
                             dtype)
        omega, _ = ref.estimate(ev, omega, schedule, dtype)
        out[:, k] = omega.double().cpu().numpy()
    return out


def measure(cell, seeds, seconds, P, dev, **run_kw):
    """The witness's readings over `seeds` (see the module's doc)."""
    import numpy as np
    import torch
    schedule = ref.Schedule.from_config(cell.config)
    lanes, port, served = [], [], []
    for seed in seeds:
        out = harness.run(cell, seed, seconds, False,
                          t_process=time.perf_counter(), judge=False,
                          device=dev, **run_kw)
        st, first = out["streams"], []
        for s in range(st.lengths.shape[0]):
            mine = [q for q in out["served"] if q.stream == s][:P]
            if [q.k for q in mine] != list(range(P)):
                raise RuntimeError(f"seed {seed} stream {s}: fewer than {P} "
                                   "windows answered from the pass's start")
            lanes.append((st, s))
            port.append([q.omega for q in mine])
            first += mine
        served.append((st, first))
    port = np.asarray(port, np.float64)
    t0 = time.perf_counter()
    r32 = own_chain(lanes, P, schedule, dev, torch.float32)
    r64 = own_chain(lanes, P, schedule, dev, torch.float64)
    t_chain = time.perf_counter() - t0
    # the served windows, each from the warm start the port was given
    same = {"port_vs_ref64": [], "ref32_vs_ref64": [], "port_vs_ref32": []}
    for st, first in served:
        a32 = check.reference_answers(first, st.window, schedule, dev)
        a64 = check.reference_answers(first, st.window, schedule, dev,
                                      torch.float64, torch.float64)
        for q in first:
            key = (q.stream, q.k, q.warm.tobytes())
            same["port_vs_ref64"].append(gap(q.omega, a64[key][0]))
            same["ref32_vs_ref64"].append(gap(a32[key][0], a64[key][0]))
            same["port_vs_ref32"].append(gap(q.omega, a32[key][0]))
    pairs = {"port_vs_ref32": gap(port, r32), "port_vs_ref64": gap(port, r64),
             "ref32_vs_ref64": gap(r32, r64)}
    marks = sorted({0, 1, 3, 7, 15, 31, P - 1} & set(range(P)))
    return {
        "workload": cell.name, "seeds": list(seeds), "lanes": len(lanes),
        "positions": P, "chain_s": t_chain,
        "own_chains": {k: summary(v) for k, v in pairs.items()},
        "median_by_position": {k: {str(i): float(np.median(v[:, i]))
                                   for i in marks}
                               for k, v in pairs.items()},
        "served_windows": {k: summary(v) for k, v in same.items()}}


def main(argv):
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--positions", type=int, required=True)
    args = ap.parse_args(argv)
    harness.cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("witness: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(measure(cell, [int(x) for x in args.seeds.split(",")],
                             args.seconds, args.positions,
                             torch.device("cuda"))), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
