#!/usr/bin/env python
"""Validate the hardware characterization tables the PyTorch port ships.

    PYTHONPATH=src python scripts/check_torch_profiles.py

`scripts/check_profiles.py`'s assertions on `repro_torch`'s own profiles
and its copy of the measured paper-scale trace: fails (exit 1) if any
shipped profile fails schema validation, if any profile stops modelling
CAMEL as cheaper than the baseline on the trace, or if the calibrated
`paper_fpga_45nm` table drifts more than 3 points from the paper's
headline ratios (−53.3% latency, −42% memory accesses, −52.2% energy).
Pure arithmetic over the trace snapshot; imports nothing of `repro`.
"""
import sys

import numpy as np

from repro_torch.core import CmaxConfig
from repro_torch.costmodel import (ProfileError, account_window,
                                   available_profiles, load_profile,
                                   paper_trace)

PAPER = "paper_fpga_45nm"
PAPER_RATIOS = {"latency": 53.3, "accesses": 42.0, "energy": 52.2}
TOL_POINTS = 3.0


def trace_ratios(hw, trace, cfg) -> dict:
    pct = lambda a, b: 100.0 * (b - a) / b
    lat_c, lat_b, acc_c, acc_b, e_c, e_b = [], [], [], [], [], []
    for stage_stats in trace["windows"]:
        ac, ec = account_window(stage_stats, cfg, hw, camel=True,
                                n_total=trace["n_total"])
        ab, eb = account_window(stage_stats, cfg, hw, camel=False,
                                n_total=trace["n_total"])
        lat_c.append(ec["latency_s"]), lat_b.append(eb["latency_s"])
        acc_c.append(ac.total_accesses), acc_b.append(ab.total_accesses)
        e_c.append(ec["e_total_uj"]), e_b.append(eb["e_total_uj"])
    return {"latency": pct(np.mean(lat_c), np.mean(lat_b)),
            "accesses": pct(np.mean(acc_c), np.mean(acc_b)),
            "energy": pct(np.mean(e_c), np.mean(e_b))}


def main() -> int:
    trace = paper_trace()
    cfg = CmaxConfig()
    failures = []
    names = available_profiles()

    for name in names:
        try:
            hw = load_profile(name)
        except ProfileError as e:
            failures.append(f"{name}: failed validation: {e}")
            continue
        r = trace_ratios(hw, trace, cfg)
        # qualitative invariant: CAMEL must be cheaper on every axis
        bad = [ax for ax, v in r.items() if v <= 0]
        if bad:
            failures.append(f"{name}: CAMEL not cheaper than baseline on "
                            f"{bad} ({r})")
        print(f"profile {name:28s} lat_red={r['latency']:5.1f}% "
              f"acc_red={r['accesses']:5.1f}% energy_red={r['energy']:5.1f}%")
        if name == PAPER:
            for ax, want in PAPER_RATIOS.items():
                if abs(r[ax] - want) > TOL_POINTS:
                    failures.append(
                        f"{PAPER}: {ax} reduction {r[ax]:.1f}% drifted "
                        f"more than {TOL_POINTS} points from the paper's "
                        f"{want}%")
    if PAPER not in names:
        failures.append(f"{PAPER} is not shipped")

    if failures:
        print("profile gate FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print(f"profile gate ok: {len(names)} profiles valid, "
          f"{PAPER} within +/-{TOL_POINTS} points of the paper ratios")
    return 0


if __name__ == "__main__":
    sys.exit(main())
