"""Budget-aware iteration scheduling across the windows of a batch
(counterpart of `repro.costmodel.scheduler`).

The adaptive controller (Alg. 1) decides when a window has stopped
improving; the `BudgetScheduler` decides how much each window is ALLOWED
to improve, by spending a joule or millisecond budget where the predicted
variance gain per unit cost is highest. It turns the paper's Alg. 1 from
a reproduction into a serving-time QoS knob (ROADMAP: accuracy-per-joule
/ accuracy-per-millisecond scheduling).

Mechanics: each window w contributes, per stage s, a ladder of candidate
iterations k = floor..max_iters-1 with

    predicted gain  g_ws(k) = gain0_ws * decay^k        (Eq. 7 geometric
                                                         saturation model)
    marginal cost   c_ws    = pass_cost(hw, stage)      (model layer)

All candidates are ranked by gain/cost (deterministic tiebreak), and the
budget buys the longest affordable prefix. The first `min_iters`
iterations of every stage are the floor — granted unconditionally, so a
zero budget still estimates (1 iteration/stage), it just never refines.
Greedy-by-ratio over a fixed ranking makes the allocation MONOTONE in the
budget: more budget can only extend the purchased prefix, never shrink
it (the reference's tests/test_costmodel.py property-checks this).

`gain0` defaults to a trace-calibrated constant but callers should feed
the measured gain of the stream's previous window (Eq. 7) — launch.serve
does exactly that, closing the measurement -> allocation loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .model import HwParams, pass_cost

# Trace-calibrated defaults for the geometric gain model: the measured
# per-iteration variance gains of the paper-scale trace start around a few
# percent and roughly halve per accepted iteration.
DEFAULT_GAIN0 = 0.04
DEFAULT_DECAY = 0.55
DEFAULT_MERGE_REDUCTION = 0.6   # trace average (paper Table 3 regime)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Per-stage inputs to the allocator for one window."""
    cost_uj: float          # marginal energy of one iteration (engine pass)
    cost_ms: float          # marginal latency of one iteration
    gain0: float            # predicted first-iteration variance gain
    decay: float            # geometric gain decay per iteration
    max_iters: int          # hard cap (HW watchdog / StageConfig.max_iters)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    stages: Tuple[StagePlan, ...]


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Result of one `allocate` call over a batch of window plans."""
    iters: np.ndarray        # (B, S) int32 per-window per-stage iteration caps
    spent_uj: float          # modelled energy of the purchased iterations
    spent_ms: float          # modelled latency of the purchased iterations
    predicted_gain: float    # sum of predicted gains of purchased iterations

    @property
    def total_iters(self) -> int:
        return int(self.iters.sum())


class BudgetScheduler:
    """Allocates adaptive iterations across a batch under a budget.

    Parameters:
      hw: the cost model (an `HwParams`, e.g. `load_profile(...)`).
      min_iters: unconditional per-stage floor (>= 1 so every window is
        estimated at least once per stage even at zero budget).
      gain0 / decay / merge_reduction: defaults for the gain and traffic
        models when a window has no measured history yet.
    """

    def __init__(self, hw: HwParams, *, min_iters: int = 1,
                 gain0: float = DEFAULT_GAIN0, decay: float = DEFAULT_DECAY,
                 merge_reduction: float = DEFAULT_MERGE_REDUCTION):
        if min_iters < 1:
            raise ValueError(f"min_iters must be >= 1, got {min_iters}")
        self.hw = hw
        self.min_iters = int(min_iters)
        self.gain0 = float(gain0)
        self.decay = float(decay)
        self.merge_reduction = float(merge_reduction)

    # -- plan construction -------------------------------------------------

    def plan_window(self, cfg, n_events: int,
                    gain0: Optional[float] = None,
                    decay: Optional[float] = None) -> WindowPlan:
        """Serving-time cost/gain estimate for one window under `cfg`
        (a CmaxConfig). Retained events are estimated from the stage
        keep-ratios (Alg. 3 retains ~rho_s * N); `gain0` should be the
        stream's last measured per-iteration gain when available."""
        g0 = self.gain0 if gain0 is None else max(float(gain0), 0.0)
        dec = self.decay if decay is None else float(decay)
        stages = []
        for stage in cfg.stages:
            Hs, Ws = stage.grid(cfg.camera)
            n_ret = stage.keep_ratio * float(n_events)
            c = pass_cost(self.hw, n_ret=n_ret, P=float(Hs * Ws),
                          taps=stage.blur_taps,
                          merge_reduction=self.merge_reduction, camel=True)
            stages.append(StagePlan(cost_uj=c.energy_uj,
                                    cost_ms=1e3 * c.seconds,
                                    gain0=g0, decay=dec,
                                    max_iters=int(stage.max_iters)))
        return WindowPlan(stages=tuple(stages))

    # -- allocation --------------------------------------------------------

    def allocate(self, plans: Sequence[WindowPlan], *,
                 budget_uj: Optional[float] = None,
                 budget_ms: Optional[float] = None) -> Allocation:
        """Spend `budget_uj` (and/or `budget_ms`) across `plans`.

        Returns per-window per-stage iteration caps. With no budget given
        every stage gets its max_iters (the adaptive controller alone
        decides); with any budget given, iterations beyond the floor are
        purchased best-gain-per-cost first until the budget is exhausted.
        """
        B = len(plans)
        S = max((len(p.stages) for p in plans), default=0)
        iters = np.zeros((B, S), np.int32)
        if B == 0:
            return Allocation(iters, 0.0, 0.0, 0.0)

        if budget_uj is None and budget_ms is None:
            for w, p in enumerate(plans):
                for s, sp in enumerate(p.stages):
                    iters[w, s] = sp.max_iters
            return Allocation(iters, float("nan"), float("nan"),
                              float("nan"))

        spent_uj = spent_ms = gained = 0.0
        # floor: min_iters per stage, unconditional
        for w, p in enumerate(plans):
            for s, sp in enumerate(p.stages):
                k = min(self.min_iters, sp.max_iters)
                iters[w, s] = k
                spent_uj += k * sp.cost_uj
                spent_ms += k * sp.cost_ms
                gained += sum(sp.gain0 * sp.decay ** i for i in range(k))

        # candidate ladder beyond the floor, ranked by gain per cost;
        # geometric decay makes utility decrease in k, so the global sort
        # keeps each (w, s) ladder in order automatically
        cands = []
        for w, p in enumerate(plans):
            for s, sp in enumerate(p.stages):
                cost = sp.cost_uj if budget_uj is not None else sp.cost_ms
                cost = max(cost, 1e-30)
                for k in range(int(iters[w, s]), sp.max_iters):
                    util = sp.gain0 * (sp.decay ** k) / cost
                    cands.append((-util, w, s, k, sp))
        cands.sort(key=lambda c: (c[0], c[1], c[2], c[3]))

        # Buy the longest affordable PREFIX of the ranking. Stopping at the
        # first unaffordable item (rather than skipping past it) is what
        # makes the allocation monotone in the budget: a bigger budget can
        # only extend the prefix, never trade one expensive iteration for
        # several cheap ones and shrink the total.
        for _, w, s, k, sp in cands:
            if budget_uj is not None and spent_uj + sp.cost_uj > budget_uj:
                break
            if budget_ms is not None and spent_ms + sp.cost_ms > budget_ms:
                break
            iters[w, s] = k + 1
            spent_uj += sp.cost_uj
            spent_ms += sp.cost_ms
            gained += sp.gain0 * sp.decay ** k
        return Allocation(iters, spent_uj, spent_ms, gained)

    # -- affordability -----------------------------------------------------

    def floor_cost(self, plan: WindowPlan) -> Tuple[float, float]:
        """Modelled (energy_uj, latency_ms) of serving `plan` at the
        unconditional floor — min_iters per stage, the cheapest execution
        `allocate` can ever produce for the window."""
        uj = ms = 0.0
        for sp in plan.stages:
            k = min(self.min_iters, sp.max_iters)
            uj += k * sp.cost_uj
            ms += k * sp.cost_ms
        return uj, ms

    def affordable(self, plan: WindowPlan, *,
                   budget_uj: Optional[float] = None,
                   budget_ms: Optional[float] = None) -> bool:
        """Whether the per-window budget covers even the floor execution.

        `allocate` grants the floor unconditionally (a zero budget still
        estimates); this is the opt-in admission test for *strict* QoS
        classes (`QosClass.strict`), which refuse windows whose floor
        already exceeds the budget instead of overspending on them.
        """
        uj, ms = self.floor_cost(plan)
        if budget_uj is not None and uj > budget_uj:
            return False
        if budget_ms is not None and ms > budget_ms:
            return False
        return True
