"""The `Workload` plugin interface for the batched estimation services
(counterpart of `repro.serving.workload`).

The services in `repro_torch.launch.serve` own the scheduler state machine
and the executable cache; a `Workload` owns everything the scheduler must
not know:

  * **bucketing** — mapping a request payload to a padded length class
    (`bucket_of`), so the set of executable classes is bounded by policy;
  * **batch materialization** — padding + leader-replicated fill into a
    `(batch_b, bucket_n)` batch on the workload's device, plus the stacked
    per-stream carried state (`make_batch`);
  * **the executable factory** — one batch function per (bucket, batch,
    flags) class (`executable`);
  * **per-stream carried state** — the CMAX warm-start omega (harvested
    state re-enters the stream's next batch);
  * **QoS budget allocation** — turning per-window joule/ms budgets into
    per-slot iteration caps (`allocate_caps`);
  * **harvest** — slicing a finished batch back into per-slot outputs,
    new carried states, iteration counts, and measured gain.

The scheduler's invariants (per-stream FIFO with carried state under any
completion order, bitwise slot independence at a fixed batch size,
deadline shedding, executable-cache accounting) are workload contracts,
held for this package by `tests/test_torch_serving.py`. The LM decode
plugin of the reference is not ported yet.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve


class SlotResult(NamedTuple):
    """One harvested batch slot."""
    output: object            # response payload (CMAX: omega (3,))
    state: object             # carried per-stream state for the next window
    iters: Tuple[int, ...]    # per-stage iteration counts (workload-defined)
    gain: Optional[float]     # measured gain for the budget feedback loop


class Workload:
    """Base interface; every method the services call is defined here.

    Subclasses must set `name` and `policy` (an object with
    ``bucket_of(n) -> int`` and ``classes(n_min, n_max)``, e.g.
    `repro_torch.data.events.BucketPolicy`) and implement the abstract
    methods.
    """

    name: str = "workload"
    #: whether budgeted QoS classes are servable (allocate_caps is real)
    supports_budgets: bool = False
    policy = None

    @property
    def budget_unsupported_msg(self) -> str:
        """Raised by the service when budgeted QoS classes are configured
        but this workload cannot serve them."""
        return (f"workload {self.name!r} does not support budgeted "
                f"QoS classes")

    # -- request side --------------------------------------------------------

    def bucket_of(self, payload) -> int:
        """Length class of one payload; must raise for unservable sizes
        (a poison request must never sit in the queue)."""
        return self.policy.bucket_of(self.size_of(payload))

    def size_of(self, payload) -> int:
        """Raw slot count of a payload (events) — the numerator of the
        service's padding accounting."""
        return payload.n

    def coerce_hint(self, hint):
        """Normalize a submitted carried-state override."""
        return hint

    # -- carried state -------------------------------------------------------

    def default_state(self):
        """Carried state for a stream's first window."""
        raise NotImplementedError

    def shed_output(self, state):
        """Response payload for a shed request (state is the stream's last
        harvested state, or None for a fresh stream)."""
        raise NotImplementedError

    # -- batch materialization / execution ----------------------------------

    def make_batch(self, payloads: Sequence, states: Sequence,
                   bucket_n: int, batch_b: int) -> Tuple[object, object, int]:
        """Pad payloads to (batch_b, bucket_n) and stack carried states;
        fill slots replicate the batch leader (finite well-formed data,
        results discarded). Returns (data_batch, state_batch, n_fill)."""
        raise NotImplementedError

    def executable(self, bucket_n: int, batch_b: int, *,
                   budgeted: bool = False, donate: bool = True) -> Callable:
        """The batch function for one (length, batch) class:
        fn(data_batch, state_batch) -> result. Cached by the service per
        (bucket_n, batch_b, budgeted) key."""
        raise NotImplementedError

    # -- QoS budgets ---------------------------------------------------------

    def allocate_caps(self, requests: Sequence, batch_b: int,
                      qos_classes: Dict, gains: Dict,
                      stats: Dict) -> Optional[np.ndarray]:
        """Per-slot work caps for one formed batch, or None when every
        member is standard. Only called when the service has budgeted QoS
        classes; the base workload does not support those."""
        raise NotImplementedError(
            f"workload {self.name!r} does not support budgeted QoS classes")

    def attach_caps(self, fn: Callable, caps: np.ndarray) -> Callable:
        """Close a cap allocation over a budgeted executable so every
        executor sees the uniform fn(data, state) submit signature."""
        raise NotImplementedError

    # -- telemetry -----------------------------------------------------------

    def decision_meta(self, result) -> Optional[dict]:
        """Per-stage decision-log metadata for one harvested batch result
        (`repro_torch.telemetry.DecisionLog`): a dict with

            "gains"     — (B, S) measured whole-residence gain per stage
            "max_iters" — (S,) static per-stage iteration bounds

        or None when the workload has no per-stage objective. Only called
        when decision logging is enabled."""
        return None

    def unaffordable(self, payload, qos, gain0=None) -> bool:
        """Strict-QoS admission test: True when even the floor execution
        of `payload` is modelled to exceed the class's per-window budget
        (such requests are refused at submit, not overspent on). The base
        workload has no cost model and never refuses."""
        return False

    # -- harvest -------------------------------------------------------------

    def harvest(self, result, track_gain: bool) -> Callable[[int], SlotResult]:
        """Batch-level harvest: returns slot(i) -> SlotResult. Per-slot
        results must depend only on that slot's inputs (the refill
        invariant); `track_gain` asks for the measured-gain feedback the
        budget scheduler consumes (None when unavailable)."""
        raise NotImplementedError

    def null_result(self, bucket_n: int, batch_b: int):
        """A harvest-compatible stand-in result for data-free executors
        (a virtual-time simulation drives the scheduler with no work)."""
        raise NotImplementedError


def _host(a) -> np.ndarray:
    """A result leaf as a numpy array (tensors are copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# CMAX: the paper's contrast-maximization pipeline as a plugin.
# ---------------------------------------------------------------------------


class CmaxWorkload(Workload):
    """Contrast-maximization estimation over variable-length event
    windows: payloads are 1-D `EventWindow`s, carried state is the (3,)
    float32 warm-start omega (a numpy array), the executable is
    `estimate_batch` (or `estimate_batch_budgeted` under budgeted QoS
    classes, with `costmodel.BudgetScheduler` iteration caps).

    Batches are built on `device` (default: the card, raising without
    one; pass "cpu" for the plain path). A `mesh` is not supported yet:
    multi-device data parallelism (`core/distributed.py`) is still to be
    ported."""

    name = "cmax"
    supports_budgets = True

    def __init__(self, cfg, policy=None, mesh=None, scheduler=None,
                 device: DeviceLike = None):
        from ..data import events as ev_data
        if mesh is not None:
            raise NotImplementedError(
                "CmaxWorkload: a mesh is not supported yet — multi-device "
                "estimation (core/distributed.py) is ROADMAP Queue 1 item 11")
        self.cfg = cfg
        self.policy = policy or ev_data.pow2_policy(min_bucket=512)
        self.device = resolve(device)
        self._scheduler = scheduler     # costmodel.BudgetScheduler (lazy)

    # -- request side --------------------------------------------------------

    def coerce_hint(self, hint):
        if hint is None:
            return None
        if isinstance(hint, torch.Tensor):
            hint = hint.detach().cpu().numpy()
        return np.asarray(hint, np.float32)

    # -- carried state -------------------------------------------------------

    def default_state(self):
        return np.zeros(3, np.float32)

    def shed_output(self, state):
        return self.default_state() if state is None else state

    # -- batch materialization / execution ----------------------------------

    def make_batch(self, payloads, states, bucket_n, batch_b):
        from ..data import events as ev_data

        omega0 = list(states)
        omega0 += [omega0[0]] * (batch_b - len(omega0))
        ev_batch, n_fill = ev_data.fill_batch(list(payloads), bucket_n,
                                              batch_b)
        dev = self.device
        ev_batch = ev_batch.map(lambda a: a.to(dev))
        om_batch = torch.as_tensor(np.stack(omega0), device=dev)
        return ev_batch, om_batch, n_fill

    def executable(self, bucket_n, batch_b, *, budgeted=False, donate=True):
        """The batch function of one class. PyTorch has no buffer
        donation, so `donate` selects nothing: both values give
        `estimate_batch` (the argument stays so the services' calls match
        the reference's). The port runs eagerly, so there is nothing to
        compile; the service's cache and `compiles` counter track the
        classes built."""
        from ..core.pipeline import estimate_batch, estimate_batch_budgeted

        cfg = self.cfg
        if budgeted:
            return lambda w, o, caps: estimate_batch_budgeted(w, o, caps,
                                                              cfg)
        return lambda w, o: estimate_batch(w, o, cfg)

    # -- QoS budgets ---------------------------------------------------------

    def _budget_scheduler(self):
        if self._scheduler is None:
            from ..costmodel import BudgetScheduler, load_profile
            self._scheduler = BudgetScheduler(load_profile("paper_fpga_45nm"))
        return self._scheduler

    def allocate_caps(self, requests, batch_b, qos_classes, gains, stats):
        classes = {r.qos: qos_classes[r.qos] for r in requests}
        if not any(q.budgeted for q in classes.values()):
            return None
        sched = self._budget_scheduler()
        S = len(self.cfg.stages)
        uncapped = max(int(s.max_iters) for s in self.cfg.stages)
        caps = np.full((batch_b, S), uncapped, np.int32)
        for name, q in classes.items():
            if not q.budgeted:
                continue
            members = [(i, r) for i, r in enumerate(requests)
                       if r.qos == name]
            plans = [sched.plan_window(self.cfg, r.window.n,
                                       gain0=gains.get(r.stream_id))
                     for _, r in members]
            alloc = sched.allocate(
                plans,
                budget_uj=None if q.budget_uj is None
                else q.budget_uj * len(members),
                budget_ms=None if q.budget_ms is None
                else q.budget_ms * len(members))
            for j, (i, _) in enumerate(members):
                caps[i] = alloc.iters[j]
            stats["budgeted_windows"] += len(members)
            if np.isfinite(alloc.spent_uj):
                stats["budget_spent_uj"] += alloc.spent_uj
        # fill slots replicate the leader's data and are discarded — cap
        # them at the 1-iteration floor so they buy no wasted refinement
        caps[len(requests):, :] = 1
        return caps

    def attach_caps(self, fn, caps):
        # the caps go to the device inside the call, on the stream that
        # runs the batch, so an executor's stream never reads memory that
        # another stream allocated and may already have freed
        caps = np.array(caps, np.int32)
        return lambda w, o: fn(w, o, torch.as_tensor(caps, device=o.device))

    # -- telemetry -----------------------------------------------------------

    def decision_meta(self, result):
        stages = getattr(result, "stages", ())
        if not stages:
            return None
        from ..core.pipeline import measured_stage_gains
        cfg = self.cfg
        max_iters = tuple(
            int(st.max_iters) if cfg.adaptive else int(cfg.fixed_iters[si])
            for si, st in enumerate(cfg.stages))
        return {"gains": measured_stage_gains(result),
                "max_iters": max_iters}

    def unaffordable(self, payload, qos, gain0=None):
        if not getattr(qos, "strict", False) or not qos.budgeted:
            return False
        sched = self._budget_scheduler()
        plan = sched.plan_window(self.cfg, payload.n, gain0=gain0)
        return not sched.affordable(plan, budget_uj=qos.budget_uj,
                                    budget_ms=qos.budget_ms)

    # -- harvest -------------------------------------------------------------

    def harvest(self, result, track_gain):
        omegas = _host(result.omega)
        stages = getattr(result, "stages", ())
        iters = [_host(tr.iters) for tr in stages]
        if track_gain and stages:
            v_ent = [_host(tr.v_entry) for tr in stages]
            v_fin = [_host(tr.v_final) for tr in stages]

        def slot(i: int) -> SlotResult:
            om = omegas[i]
            gain = None
            if track_gain and stages:
                # measured Eq. 7 gain per accepted iteration, averaged over
                # stages — feeds the scheduler's gain model for this
                # stream's NEXT window (closing measurement -> allocation)
                g = [(vf[i] - ve[i]) / ((abs(ve[i]) + 1e-12)
                                        * max(int(it[i]), 1))
                     for ve, vf, it in zip(v_ent, v_fin, iters)]
                gain = max(float(np.mean(g)), 0.0)
            return SlotResult(om, om, tuple(int(it[i]) for it in iters),
                              gain)
        return slot

    def null_result(self, bucket_n, batch_b):
        return types.SimpleNamespace(
            omega=np.zeros((batch_b, 3), np.float32), stages=())
