"""Fault-tolerance harness (counterpart of `repro.train.ft`, pure Python,
the same behaviour): retrying step execution, straggler detection, and
(simulated) elastic re-meshing.

On a real 1000+-node fleet, failures surface as (a) raised RuntimeErrors
from collectives when a host dies, (b) stragglers (slow steps from a sick
chip / thermal throttling), (c) preemptions. The harness wires the standard
mitigations:

  * `RetryPolicy.run` — catch, restore from the last committed checkpoint,
    rebuild the step (possibly on a NEW mesh — elastic), and continue.
  * `StragglerDetector` — per-step wall-time EWMA + z-score; a step slower
    than mean + k*sigma is flagged; after `patience` consecutive flags the
    harness requests a re-mesh (dropping the slow host in a real fleet).
  * `FaultInjector` — deterministic failure/straggle injection for tests
    and the chaos example (examples/torch_fault_tolerant_train.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.2          # EWMA factor
    z_threshold: float = 3.0
    patience: int = 3
    warmup: int = 5

    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    consecutive: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            # prime the stats
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        sigma = max(np.sqrt(self.var), 1e-6)
        is_slow = dt > self.mean + self.z_threshold * sigma
        self.consecutive = self.consecutive + 1 if is_slow else 0
        # only non-straggler samples update the baseline
        if not is_slow:
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_slow

    @property
    def should_remesh(self) -> bool:
        return self.consecutive >= self.patience


@dataclasses.dataclass
class FaultInjector:
    """Deterministic chaos for tests: fail at given steps, straggle at
    others."""
    fail_at: tuple = ()
    straggle_at: tuple = ()
    straggle_s: float = 0.25
    _failed: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._failed:
            self._failed.add(step)   # fail once per step (restart survives)
            raise RuntimeError(f"injected node failure at step {step}")

    def maybe_straggle(self, step: int):
        if step in self.straggle_at:
            time.sleep(self.straggle_s)


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 5
    backoff_s: float = 0.1

    def run(self, body: Callable[[int], None], *,
            on_restart: Optional[Callable[[int], None]] = None) -> int:
        """Run `body(restart_count)` to completion, restarting on
        RuntimeError up to max_restarts times. Returns restart count."""
        restarts = 0
        while True:
            try:
                body(restarts)
                return restarts
            except RuntimeError as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                print(f"[ft] failure: {e}; restart {restarts}/"
                      f"{self.max_restarts}")
                if on_restart is not None:
                    on_restart(restarts)
                time.sleep(self.backoff_s * restarts)
