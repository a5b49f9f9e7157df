"""Async continuous-batching estimation service on the PyTorch/CUDA port:
submit ragged windows from several concurrent event streams — with
priorities and per-request deadlines — poll while batches are in flight,
read back per-stream warm-started estimates.

    PYTHONPATH=src python examples/torch_serve_batch.py               # card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu  # plain

`--windows` (per stream) and `--events` (the longest window) shrink the
run (defaults: the reference example's 3 windows of 1,500 to 4,096
events from each of 4 streams).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import CmaxConfig  # noqa: E402
from repro_torch.data import events as ev  # noqa: E402
from repro_torch.launch.serve import AsyncBatchedEstimationService  # noqa


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--events", type=int, default=4096)
    args = ap.parse_args(argv)
    n_win, n_max = args.windows, args.events
    n_min = min(1500, n_max)

    # 1) a service: pow2 length buckets from 1024 events, batches up to 4,
    #    up to 2 batches in flight (one computing + one queued)
    cfg = CmaxConfig()
    svc = AsyncBatchedEstimationService(
        cfg, policy=ev.pow2_policy(min_bucket=1024), max_batch=4,
        max_in_flight=2, device=args.device)

    # 2) submit the windows of 4 synthetic camera streams, with variable
    #    event counts (what a real DVS front-end produces). Admission is
    #    non-blocking: batches dispatch and compute while we are still
    #    submitting — poll() harvests whatever has finished.
    truth = {}
    responses = []
    for s in range(4):
        spec = ev.SequenceSpec(name=f"cam{s}", n_windows=n_win,
                               events_per_window=n_max, seed=40 + s)
        wins, om_true, _ = ev.make_sequence(spec, device=args.device)
        truth[f"cam{s}"] = om_true.cpu().numpy()
        lens = ev.ragged_lengths(n_win, n_min, n_max, seed=s)
        for k, w in enumerate(ev.ragged_from_sequence(wins, lens)):
            # first window of a stream gets an IMU-style hint; later
            # windows warm-start from the previous estimate automatically.
            # cam0 is a high-priority stream; every window carries a
            # deadline (a request still queued past it is shed, not
            # computed — generous here)
            hint = truth[f"cam{s}"][0] if k == 0 else None
            svc.submit(f"cam{s}", w, omega_hint=hint,
                       priority=1 if s == 0 else 0,
                       deadline=svc.clock.now() + 120.0)
        responses.extend(svc.poll())          # overlap admission + compute

    # 3) drain what is still queued or in flight, and report
    responses.extend(svc.drain())
    svc.executor.close()
    print("stream  seq  status  bucket  batch   |est|     err(rad/s)  latency")
    errs = []
    for r in responses:
        err = float(np.linalg.norm(r.omega - truth[r.stream_id][r.seq]))
        errs.append(err)
        print(f"{r.stream_id:>6} {r.seq:4d} {r.status:>7} {r.bucket_n:7d}"
              f" {r.batch_b:6d}   {np.linalg.norm(r.omega):6.3f}"
              f"   {err:9.4f}   {1e3 * r.latency:6.1f}ms")
    print(f"\n{svc.stats['windows']} windows in {svc.stats['batches']} "
          f"batches, {svc.stats['compiles']} executables, "
          f"{svc.stats['shed']} shed, padded slot fraction "
          f"{svc.padded_slot_frac:.3f}")
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    print(f"RMSE vs ground truth: {rmse:.4f} rad/s")
    return rmse


if __name__ == "__main__":
    main()
