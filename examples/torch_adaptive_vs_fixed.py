"""The paper's Table 1 comparison on the PyTorch/CUDA port: full-resolution
CMAX vs fixed-schedule coarse-to-fine vs runtime-adaptive CMAX-CAMEL, on
the two synthetic paper-style sequences (poster / boxes), with compute
cost — plus a third arm, budget-scheduled adaptive: the same adaptive
controller under BudgetScheduler iteration caps, sweeping the energy
budget to trace the accuracy-vs-spent-joules curve.

    PYTHONPATH=src python examples/torch_adaptive_vs_fixed.py     # the card
    PYTHONPATH=src python examples/torch_adaptive_vs_fixed.py --device cpu

`--windows` and `--events` shrink the run (defaults: the reference
example's 16 windows of 4,096 events per sequence). The spent energy is
the cost model's (`paper_fpga_45nm`), not a measurement of the card.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (CmaxConfig, estimate_sequence,  # noqa: E402
                              estimate_window_budgeted,
                              fixed_schedule_config, full_resolution_config)
from repro_torch.costmodel import BudgetScheduler, load_profile  # noqa: E402
from repro_torch.data import events as ev  # noqa: E402


def budget_arm(spec, wins, om_imu, cfg, budget_fracs=(0.1, 0.3, 1.0)):
    """Warm-start-chained estimation under per-window energy budgets.

    Budgets are fractions of the full-allocation modelled cost under the
    paper profile; the spent column is the scheduler's modelled energy of
    the iterations it granted."""
    sched = BudgetScheduler(load_profile("paper_fpga_45nm"))
    plan = sched.plan_window(cfg, spec.events_per_window)
    full_uj = sched.allocate([plan], budget_uj=1e15).spent_uj
    rows = []
    for frac in budget_fracs:
        alloc = sched.allocate([plan], budget_uj=frac * full_uj)
        caps = torch.as_tensor(alloc.iters[0], device=om_imu.device)
        om = om_imu[0]
        ests = []
        for k in range(spec.n_windows):
            res = estimate_window_budgeted(ev.window_slice(wins, k), om,
                                           caps, cfg)
            om = res.omega
            ests.append(om.cpu().numpy())
        err = np.linalg.norm(np.stack(ests) - om_imu.cpu().numpy(), axis=1)
        rows.append((frac, alloc.spent_uj * spec.n_windows,
                     float(np.sqrt((err ** 2).mean()))))
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--events", type=int, default=4096)
    args = ap.parse_args(argv)
    table = {}
    for base in (ev.POSTER, ev.BOXES):
        spec = dataclasses.replace(base, n_windows=args.windows,
                                   events_per_window=args.events,
                                   omega_scale=7.0, window_dt=0.03,
                                   jerk_prob=0.25)
        wins, om_true, om_imu = ev.make_sequence(spec, device=args.device)
        imu = om_imu.cpu().numpy()
        print(f"\n=== {spec.name} ===")
        methods = {
            "full-resolution": full_resolution_config(spec.camera),
            "fixed-schedule": fixed_schedule_config(spec.camera,
                                                    iters=(6, 6, 8)),
            "runtime-adaptive": CmaxConfig(camera=spec.camera),
        }
        base_rmse = None
        for name, cfg in methods.items():
            oms, res = estimate_sequence(wins, om_imu[0], cfg)
            err = np.linalg.norm(oms.cpu().numpy() - imu, axis=1)
            rmse = float(np.sqrt((err ** 2).mean()))
            cost = 0.0
            for s, st in zip(cfg.stages, res.stages):
                Hs, Ws = s.grid(spec.camera)
                cost += float((st.passes.cpu().numpy().astype(float)
                               * (st.n_retained.cpu().numpy().astype(float)
                                  + Hs * Ws / 2)).sum())
            if name == "fixed-schedule":
                base_rmse = rmse
            extra = ""
            if name == "runtime-adaptive" and base_rmse:
                extra = (f"  ({100 * (base_rmse - rmse) / base_rmse:+.1f}% "
                         f"vs fixed)")
            print(f"  {name:18s} rmse={rmse:7.4f} rad/s  "
                  f"cost={cost / 1e6:6.2f}M cycles-eq{extra}")
            table[(spec.name, name)] = (rmse, cost)

        cfg = CmaxConfig(camera=spec.camera)
        for frac, spent_uj, rmse in budget_arm(spec, wins, om_imu, cfg):
            print(f"  budget-scheduled   rmse={rmse:7.4f} rad/s  "
                  f"spent={spent_uj / 1e3:6.2f}mJ (budget={100 * frac:.0f}% "
                  f"of full allocation)")
            table[(spec.name, f"budget-{frac}")] = (rmse, spent_uj)
    return table


if __name__ == "__main__":
    main()
