"""How `correct` is decided: every window answered in a run is held to the
plain reference (`reference/cmax.py`), run on the same host windows once
the window has closed.

The reference follows each stream's served chain: it estimates window k
from the warm start the service was bound to use, the stream's previous
served answer (or, at the start of a pass over the recording, the IMU
hint the benchmark gave). It cannot work the chain out alone: the
estimator's accept and stop decisions turn on differences at the last bit
of float32, so two sound implementations drift apart along a chain
(`witness.py` measures the drift against a float64 chain; see PERF.md). A window served twice from the same warm start is estimated
once.

The numbers compared, each against the limit its configuration states:

  omega_gap_median   median over the answered windows of the largest
                     |omega_served - omega_reference| component, rad/s
  omega_gap_share    share of the answered windows whose gap exceeds the
                     last stage's smallest step (alpha0 / 64)
  iters_differ_share share of the answered windows whose iterations per
                     stage differ from the reference's
  unanswered         windows due in the window that got no answer

(`omega_gap_max`, the widest gap, is printed beside them and not
compared: a window whose late decisions went the other way is one step
of the last stage off, so the widest gap of a sound run and of the
control overlap.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import cmax as ref


@dataclasses.dataclass
class Served:
    """One answered window, as the benchmark saw it."""

    stream: int
    k: int                    # index in the stream's recording
    warm: np.ndarray          # (3,) the warm start it was bound to use
    omega: np.ndarray         # (3,) the served answer
    iters: Tuple[int, ...]    # the served iterations per stage


def events_of(wins, device, work=torch.float32):
    """The reference's input for host windows (x, y, t, p, valid): padded
    to the longest, stacked, on `device`, in the working precision `work`,
    each window's times from its first event."""
    n = max(w[0].shape[0] for w in wins)
    pad = lambda a: torch.nn.functional.pad(a, (0, n - a.shape[0]))
    x, y, t, p, valid = (torch.stack([pad(w[f]) for w in wins]).to(device)
                         for f in range(5))
    t = t - torch.where(valid, t, torch.inf).amin(1, keepdim=True)
    return tuple(a.to(work) for a in (x, y, t, p)) + (valid,)


def reference_answers(served: List[Served], windows, schedule, device,
                      dtype=torch.float32, work=torch.float32,
                      block: int = 128
                      ) -> Dict[tuple, Tuple[np.ndarray, np.ndarray]]:
    """The reference's (omega, iterations) per distinct (stream, k, warm
    start), estimated in blocks of `block` windows on `device`, its engine
    pass in `dtype` and the rest in `work`. `windows(stream, k)` gives the
    host window (x, y, t, p, valid)."""
    keys = sorted({(s.stream, s.k, s.warm.tobytes()) for s in served})
    out = {}
    for i in range(0, len(keys), block):
        part = keys[i:i + block]
        warm = torch.as_tensor(np.stack([np.frombuffer(w, np.float32)
                                         for _, _, w in part]),
                               device=device)
        om, it = ref.estimate(
            events_of([windows(st, k) for st, k, _ in part], device, work),
            warm, schedule, dtype)
        om, it = om.cpu().numpy(), it.cpu().numpy()
        for j, key in enumerate(part):
            out[key] = (om[j], it[j])
    return out


def compare(served: List[Served], answers, schedule: ref.Schedule
            ) -> Dict[str, float]:
    """The numbers compared, over every answered window."""
    step = schedule.step_size * schedule.stages[-1].step_scale / 64.0
    gaps, differ = [], 0
    for s in served:
        om, it = answers[(s.stream, s.k, s.warm.tobytes())]
        gaps.append(float(np.max(np.abs(s.omega.astype(np.float64) - om))))
        differ += tuple(int(v) for v in it) != tuple(s.iters)
    if not gaps:
        return {}
    return {"omega_gap_median": float(np.median(gaps)),
            "omega_gap_share": float(np.mean(np.array(gaps) > step)),
            "iters_differ_share": differ / len(gaps),
            "omega_gap_max": float(np.max(gaps))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """correct iff every number the configuration limits is at or under
    its limit; each such number beside its limit."""
    shown = {k: {"value": numbers.get(k), "limit": lim}
             for k, lim in limits.items()}
    ok = all(numbers.get(k, float("inf")) <= lim
             for k, lim in limits.items())
    return ok, shown
