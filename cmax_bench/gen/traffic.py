"""The general generator of traffic: one reader of every mix file.

A mix (`traffic/<mix>.json`) states:

  streams             cameras, each replaying one recorded sequence
  recording_windows   windows in each recording, replayed cyclically
  events              {"law": "fixed", "n": N}: every window holds N events
  loop                "closed": every stream keeps `outstanding` windows
                      submitted and not yet answered (a backlog);
                      "open": windows arrive on a schedule at `rate_per_s`
                      in all, whatever the service does
  pool_seed           the recordings are drawn once from this seed; the
                      run's seed deals them to the streams and picks the
                      window each stream starts at

Open-loop arrivals are the recording's own timing: every window of a
recording spans the scene's `window_dt` and holds its N events
(`events.record`), so a camera that cuts its stream every N events
delivers one window a period. The mix plays that timing at `rate_per_s`
in all: each stream sends a window every streams / rate_per_s seconds,
from a phase drawn with the mix's `arrival_seed`.

The arrival times and the set of windows are the mix's own; the run's
seed deals the pool's recordings and rotates each, so every seed offers
the same load in another arrangement.
"""
from __future__ import annotations

import math
from typing import List

import torch


def window_lengths(traffic: dict, n_streams: int, n_windows: int
                   ) -> torch.Tensor:
    """(streams, recording_windows) int64 event counts of the windows."""
    law = traffic["events"]
    if law["law"] != "fixed":
        raise ValueError(f"unknown length law {law['law']!r}")
    return torch.full((n_streams, n_windows), int(law["n"]),
                      dtype=torch.int64)


def arrival_offsets(traffic: dict, seconds: float) -> List[torch.Tensor]:
    """Open loop: per stream, the ascending arrival times (seconds from the
    window's start) in [0, seconds): one window every streams / rate_per_s
    seconds from a uniform phase drawn with the mix's `arrival_seed`."""
    if traffic["loop"] != "open":
        raise ValueError("arrival_offsets reads open-loop mixes")
    streams = int(traffic["streams"])
    period = streams / float(traffic["rate_per_s"])
    out = []
    for s in range(streams):
        g = torch.Generator().manual_seed(
            int(traffic["arrival_seed"]) * 65_537 + s)
        phase = float(torch.rand(1, generator=g, dtype=torch.float64)) \
            * period
        n = int(math.ceil((seconds - phase) / period))
        out.append(phase + period * torch.arange(n, dtype=torch.float64))
    return out
