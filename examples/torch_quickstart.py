"""Quickstart on the PyTorch/CUDA port: estimate camera rotation from a
synthetic event stream with runtime-adaptive CMAX (the paper's pipeline).

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain

`--windows` and `--events` shrink the run (defaults: the reference
example's 8 windows of 4,096 events).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import CmaxConfig, estimate_sequence  # noqa: E402
from repro_torch.data import events as ev  # noqa: E402


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--events", type=int, default=4096)
    args = ap.parse_args(argv)

    # 1) make a short synthetic sequence with ground-truth rotation
    spec = ev.SequenceSpec(name="quickstart", n_windows=args.windows,
                           events_per_window=args.events, omega_scale=6.0,
                           window_dt=0.03, seed=7)
    windows, omega_true, omega_imu = ev.make_sequence(spec,
                                                      device=args.device)

    # 2) run the runtime-adaptive coarse-to-fine pipeline with warm starts
    cfg = CmaxConfig(camera=spec.camera)
    omegas, traces = estimate_sequence(windows, omega_true[0], cfg)

    # 3) report
    est = omegas.cpu().numpy()
    true = omega_true.cpu().numpy()
    err = np.linalg.norm(est - true, axis=1)
    print("window |  true |omega|  est |omega|   err (rad/s)  iters/stage")
    for k in range(spec.n_windows):
        iters = [int(t.iters[k]) for t in traces.stages]
        print(f"  {k:2d}   |   {float(np.linalg.norm(true[k])):6.3f}"
              f"     |   {float(np.linalg.norm(est[k])):6.3f}   "
              f"| {err[k]:8.4f}    | {iters}")
    rmse = float(np.sqrt((err ** 2).mean()))
    print(f"\nRMSE vs ground truth: {rmse:.4f} rad/s")
    return rmse


if __name__ == "__main__":
    main()
