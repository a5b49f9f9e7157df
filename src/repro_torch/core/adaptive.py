"""Runtime-adaptive stage-transition control (paper Algorithm 1;
counterpart of `repro.core.adaptive`).

The controller logic is deliberately tiny and separate from the datapath:

  * `gain` / `should_stay` — the pure decision functions of the residence
    loop in pipeline.py.
  * `GainThresholdController` — a reusable runtime-adaptive iteration
    controller (gain-thresholded saturation detection with a hard cap),
    usable for any iterative computation.
  * `BudgetedGainThresholdController` — the budget-aware variant: the same
    saturation logic plus a per-run iteration cap that a scheduler hands
    in as data.

The loops run on the host and read the stop flag back once per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


def gain(v: torch.Tensor, v_prev: torch.Tensor,
         eps: float = 1e-12) -> torch.Tensor:
    """Normalized variance gain g = (V - V_prev) / |V_prev|   (Eq. 7)."""
    return (v - v_prev) / torch.clamp(torch.abs(v_prev), min=eps)


def should_stay(v: torch.Tensor, v_prev: torch.Tensor,
                tau: float) -> torch.Tensor:
    """Alg. 1 line 7: keep the current stage iff g >= tau_s."""
    return gain(v, v_prev) >= tau


def _run_gain_loop(step: Callable, state, v0, tau: float, cap: int):
    st, v, it, done = state, v0, 0, False
    while not done and it < cap:
        v_prev = v
        st, v = step(st)
        done = not bool(should_stay(torch.as_tensor(v),
                                    torch.as_tensor(v_prev), tau))
        it += 1
    return st, v, torch.tensor(it, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class GainThresholdController:
    """Generic runtime-adaptive iteration loop.

    Repeats `step` while the normalized objective gain stays >= tau, up to
    `max_iters`. `step(state) -> (state, value)`.
    Returns (final_state, final_value, iters_executed)."""

    tau: float
    max_iters: int

    def run(self, step: Callable, state, v0
            ) -> Tuple[object, torch.Tensor, torch.Tensor]:
        return _run_gain_loop(step, state, v0, self.tau, self.max_iters)


@dataclasses.dataclass(frozen=True)
class BudgetedGainThresholdController:
    """`GainThresholdController` under an externally allocated budget.

    `run(step, state, v0, iter_cap)` iterates while the gain stays >= tau,
    up to min(max_iters, iter_cap). A cap of 0 executes no iterations."""

    tau: float
    max_iters: int

    def run(self, step: Callable, state, v0, iter_cap
            ) -> Tuple[object, torch.Tensor, torch.Tensor]:
        cap = min(int(self.max_iters), int(iter_cap))
        return _run_gain_loop(step, state, v0, self.tau, cap)


def residence_verdict(iters: int, cap=None, max_iters=None) -> str:
    """Classify one stage residence for the telemetry decision log.

    Whichever bound the iteration count hit names what ended the stay:

      "skip" — zero iterations (cap of 0, or an empty slot);
      "cap"  — the budget scheduler's cap bound it (cap < max_iters hit);
      "max"  — the static watchdog bound it (max_iters hit);
      "run"  — neither bound hit: the Alg. 1 gain test stopped it.

    Pure Python on already-harvested ints."""
    it = int(iters)
    if it <= 0:
        return "skip"
    eff_cap = None
    if cap is not None and max_iters is not None:
        eff_cap = min(int(cap), int(max_iters))
    elif cap is not None:
        eff_cap = int(cap)
    if eff_cap is not None and it >= eff_cap:
        return "cap" if (max_iters is None or eff_cap < int(max_iters)) \
            else "max"
    if max_iters is not None and it >= int(max_iters):
        return "max"
    return "run"
