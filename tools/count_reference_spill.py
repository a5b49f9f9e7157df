"""Count the taps the JAX `pallas_batched` engine drops at the paper's size.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/count_reference_spill.py

For POSTER windows of 40,000 events with 2,500 features (no jerks; the
workload behind costmodel/profiles/paper_trace_40k.json) and the default
CmaxConfig, this mirrors `repro.kernels.ops._bin_taps_one` in numpy at each
stage's entry pass (warm start = the IMU reference, weights from
`sort_events`): contributing taps binned by row slab (rb=8), and the taps
beyond `engine_capacity` per slab that `batched_engine_stats` drops and only
counts. The port's kernel has no capacity, so it drops none. A count on the
CPU, no timing.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import CmaxConfig, sort_events, warp_events
from repro.data import events


def main() -> None:
    cfg = CmaxConfig()
    cam, rb, cap = cfg.camera, cfg.engine_rb, cfg.engine_capacity
    spec = dataclasses.replace(events.POSTER, n_windows=2,
                               events_per_window=40000, n_features=2500,
                               jerk_prob=0.0)
    wins, _, om_imu = events.make_sequence(spec)
    for k in range(spec.n_windows):
        ev = events.window_slice(wins, k)
        om = jnp.asarray(om_imu[k])
        for st in cfg.stages:
            weights = sort_events(ev, om, cam, st).weights
            w = warp_events(ev, om, cam, st.scale)
            pw = np.asarray(ev.p) * np.asarray(weights)
            live = np.asarray(w.in_range) & (pw != 0.0)
            rows = np.concatenate([np.asarray(w.y0) + dy
                                   for dy in (0, 0, 1, 1)])
            Hs, _ = st.grid(cam)
            n_slabs = -(-(Hs + st.blur_taps // 2) // rb)
            cnt = np.bincount(rows[np.tile(live, 4)] // rb,
                              minlength=n_slabs)[:n_slabs]
            dropped = int(np.maximum(cnt - cap, 0).sum())
            print(f"window {k} s={st.scale}: {int(cnt.sum())} contributing "
                  f"taps, busiest slab {int(cnt.max())}, dropped at "
                  f"capacity {cap}: {dropped}")


if __name__ == "__main__":
    main()
