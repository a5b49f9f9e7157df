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
  * **per-stream carried state** — the CMAX warm-start omega, the LM
    per-stream KV/recurrent cache (harvested state re-enters the stream's
    next batch);
  * **QoS budget allocation** — turning per-window joule/ms budgets into
    per-slot iteration caps (`allocate_caps`);
  * **harvest** — slicing a finished batch back into per-slot outputs,
    new carried states, iteration counts, and measured gain.

The scheduler's invariants (per-stream FIFO with carried state under any
completion order, bitwise slot independence at a fixed batch size,
deadline shedding, executable-cache accounting) are workload contracts,
held for this package by `tests/test_torch_serving.py` (CMAX) and
`tests/test_torch_lm_serving.py` (LM decode).
"""
from __future__ import annotations

import types
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve


class SlotResult(NamedTuple):
    """One harvested batch slot."""
    output: object            # response payload (CMAX: omega (3,); LM: tokens)
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
        """Raw slot count of a payload (events / tokens) — the numerator
        of the service's padding accounting."""
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
    one; pass "cpu" for the plain path). Under a `mesh` (a
    `launch.mesh.DeviceGrid`) batches are built on the grid's first device
    and run through `core.distributed.estimate_batch_sharded`, one shard
    per data-parallel index; budgeted QoS classes are then refused."""

    name = "cmax"

    def __init__(self, cfg, policy=None, mesh=None, scheduler=None,
                 device: DeviceLike = None):
        from ..data import events as ev_data
        self.cfg = cfg
        self.policy = policy or ev_data.pow2_policy(min_bucket=512)
        self.mesh = mesh
        self.device = (resolve(device) if mesh is None
                       else resolve(mesh.devices.flat[0]))
        self._scheduler = scheduler     # costmodel.BudgetScheduler (lazy)

    @property
    def supports_budgets(self) -> bool:
        # estimate_batch_sharded has no budgeted variant yet
        return self.mesh is None

    @property
    def budget_unsupported_msg(self) -> str:
        return ("budgeted QoS classes are not supported with a "
                "mesh (estimate_batch_sharded has no budgeted "
                "variant yet)")

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
        """The batch function of one class: `estimate_batch_donated` for
        `donate` (the async service's), else `estimate_batch`, as the
        reference's. PyTorch donates no buffer, so the two give the same
        results bit for bit. The port runs eagerly, so there is nothing
        to compile; the service's cache and `compiles` counter track the
        classes built."""
        from ..core.pipeline import (estimate_batch, estimate_batch_budgeted,
                                     estimate_batch_donated)

        cfg = self.cfg
        if self.mesh is not None:
            from ..core.distributed import estimate_batch_sharded
            mesh = self.mesh
            return lambda w, o: estimate_batch_sharded(w, o, cfg, mesh)
        if budgeted:
            return lambda w, o, caps: estimate_batch_budgeted(w, o, caps,
                                                              cfg)
        if donate:
            return lambda w, o: estimate_batch_donated(w, o, cfg)
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


# ---------------------------------------------------------------------------
# LM decode: variable-length token chunks, per-stream KV state carried
# across chunks — the same serving shape as CMAX streams.
# ---------------------------------------------------------------------------


class LMChunkResult(NamedTuple):
    """One served chunk batch: argmax next-token predictions per real
    position (-1 in pad slots), the real lengths, the advanced per-stream
    states (one {"cache": ...} per slot) and, when requested, the
    per-position logits (zeros in pad slots)."""
    tokens: object           # (B, bucket_n) int32, -1 beyond each length
    lens: object             # (B,) int32
    state: object            # list of per-slot {"cache": ...}
    logits: object = None    # (B, bucket_n, V) float32 when requested


class LMDecodeWorkload(Workload):
    """LM decode served in variable-length chunks through the bucketed
    service.

    A request payload is a `TokenChunk` (repro_torch.data.lm): the next L
    observed tokens of one stream. Serving a chunk runs L single-token
    decode steps against the stream's carried KV/recurrent cache
    (teacher-forced continuation — step t consumes token t and predicts
    token t+1), then carries the advanced cache to the stream's next chunk,
    as CMAX carries warm-start omegas.

    Each slot of a batch runs as its own batch-1 decode chain (the
    reference vmaps one stream's chunk scan over the slots): per-slot
    results are then the bits of the batch-1 chain by construction — each
    slot has its own cache position, its own MoE capacity
    (`capacity_of(cfg, 1)`) and its own pad handling — which is the slot
    independence the service's out-of-order refill relies on. Pad steps
    are not run (the reference runs them as masked no-ops and keeps the
    carry, so the result is the same), and fill slots, which replicate the
    batch leader, take the leader's results rather than recomputing them.
    A chunk starts from a clone of the stream's state, so a carried state
    is never changed by the batch that reads it.

    The model is built on `device` (default: the card, raising without
    one; pass "cpu" for the CPU) from `torch.Generator` seed `param_seed`,
    unless `params` (a `models.transformer.Transformer` on that device) is
    given.
    """

    name = "lm_decode"
    supports_budgets = False
    PAD_TOKEN = 0            # pad input id (never influences real outputs)

    def __init__(self, model_cfg, params=None, policy=None,
                 max_len: int = 512, return_logits: bool = False,
                 param_seed: int = 0, device: DeviceLike = None):
        from ..data import lm as lm_data
        self.cfg = model_cfg
        self.policy = policy or lm_data.chunk_policy()
        self.max_len = int(max_len)
        self.return_logits = bool(return_logits)
        self.device = resolve(device)
        if params is not None:
            where = next(params.parameters()).device
            if where.type != self.device.type:
                raise ValueError(f"params are on {where}, the workload "
                                 f"serves on {self.device}")
        self._params = params
        self._param_seed = param_seed

    # -- model plumbing ------------------------------------------------------

    @property
    def params(self):
        """The model (built on first use when none was given)."""
        if self._params is None:
            from ..models import transformer as tfm
            need_pos = self.cfg.pos_embedding == "learned"
            g = torch.Generator(device=self.device).manual_seed(
                self._param_seed)
            self._params = tfm.init_params(
                self.cfg, g, max_len=self.max_len if need_pos else 0,
                device=self.device)
        return self._params

    @torch.inference_mode()
    def _run_chunk_batch(self, data, states) -> LMChunkResult:
        """Every real slot's chunk as a batch-1 decode chain, under
        `torch.inference_mode()` (the model's parameters are trainable; no
        graph is recorded)."""
        from ..models import transformer as tfm

        toks, lens, n_real = data
        model = self.params
        B, n = toks.shape
        preds = torch.full((B, n), -1, dtype=torch.int32, device=toks.device)
        rows = torch.zeros((B, n, self.cfg.vocab_size), dtype=torch.float32,
                           device=toks.device) if self.return_logits \
            else None
        out_states = []
        for i in range(n_real):
            cache = tfm.clone_cache(states[i]["cache"])
            for t in range(int(lens[i])):
                logits, cache = tfm.decode_step(model, toks[i:i + 1, t:t + 1],
                                                cache)
                row = logits[0, -1]                         # (V,) float32
                preds[i, t] = torch.argmax(row)
                if rows is not None:
                    rows[i, t] = row
            out_states.append({"cache": cache})
        # fill slots replicate the leader's data, so they take its results
        preds[n_real:] = preds[0]
        if rows is not None:
            rows[n_real:] = rows[0]
        out_states += [out_states[0]] * (B - n_real)
        return LMChunkResult(tokens=preds, lens=torch.as_tensor(lens),
                             state=out_states, logits=rows)

    # -- carried state -------------------------------------------------------

    def default_state(self):
        from ..models import transformer as tfm
        return {"cache": tfm.init_cache(self.cfg, 1, self.max_len,
                                        self.device)}

    def shed_output(self, state):
        return np.zeros((0,), np.int32)      # no tokens were decoded

    # -- batch materialization / execution ----------------------------------

    def make_batch(self, payloads, states, bucket_n, batch_b):
        """Tokens padded to (batch_b, bucket_n) on the device, the lengths
        and the count of real slots on the host; states as a list (fill
        slots repeat the leader's)."""
        from ..data import lm as lm_data

        toks, lens, n_fill = lm_data.fill_chunk_batch(
            list(payloads), bucket_n, batch_b, pad_id=self.PAD_TOKEN)
        st = list(states) + [states[0]] * n_fill
        data = (torch.as_tensor(toks, device=self.device), lens,
                batch_b - n_fill)
        return data, st, n_fill

    def executable(self, bucket_n, batch_b, *, budgeted=False, donate=True):
        """The batch function of one class. PyTorch has no buffer
        donation, so `donate` selects nothing (a chunk clones the state it
        reads); the port runs eagerly, so every class shares one
        function and the service's `compiles` counter tracks the classes
        built."""
        if budgeted:
            raise NotImplementedError(
                "LMDecodeWorkload has no budgeted executable")
        return self._run_chunk_batch

    # -- harvest -------------------------------------------------------------

    def harvest(self, result, track_gain):
        toks = _host(result.tokens)
        lens = _host(result.lens)
        state = result.state

        def slot(i: int) -> SlotResult:
            L = int(lens[i])
            out = toks[i, :L].copy()
            new_state = None if state is None else state[i]
            return SlotResult(out, new_state, (L,), None)
        return slot

    def null_result(self, bucket_n, batch_b):
        return types.SimpleNamespace(
            tokens=np.full((batch_b, bucket_n), -1, np.int32),
            lens=np.zeros((batch_b,), np.int32), state=None)
