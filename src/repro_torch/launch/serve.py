"""Serving launchers: the async continuous-batching estimation service
(+ the synchronous baseline), workload-agnostic over `Workload` plugins
(counterpart of `repro.launch.serve`).

The primary entry point is `AsyncBatchedEstimationService` (DESIGN.md
§Serving): an admission -> bucket -> in-flight -> refill -> completion
loop over variable-length request payloads. Requests are admitted while
batches are in flight (each batch runs on a worker thread under its own
CUDA stream), a finished batch's capacity is refilled immediately without
waiting for the queue to drain, and per-request deadline/priority classes
shed late windows instead of letting them stall the queue.

Everything workload-specific lives behind the `repro_torch.serving.Workload`
plugin interface. The default plugin is `CmaxWorkload` (variable-length
event windows, warm-start omega carried per stream), built from a
`CmaxConfig` and a `device` (default: the card).

Requests may carry a QoS class (`QosClass`) with a per-window energy
and/or modelled-latency budget: the service turns the budget into per-slot
iteration caps via `costmodel.BudgetScheduler` and dispatches through
`estimate_batch_budgeted`:

    # async continuous-batching CMAX service over synthetic ragged streams,
    # on the card through the batched engine-pass kernel
    PYTHONPATH=src python -m repro_torch.launch.serve cmax \\
        --streams 4 --windows 4 --policy pow2

    # the per-window kernels instead; or the plain path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve cmax --engine cuda
    PYTHONPATH=src python -m repro_torch.launch.serve cmax --device cpu

    # LM decode in variable-length token chunks (LMDecodeWorkload, the
    # architecture's reduced smoke config), per-stream KV cache carried
    PYTHONPATH=src python -m repro_torch.launch.serve lm \\
        --arch llama3.2-1b --device cpu

Library use:

    from repro_torch.launch.serve import AsyncBatchedEstimationService

    svc = AsyncBatchedEstimationService(cfg)          # device="cuda"
    svc.submit("cam0", window_a, deadline=svc.clock.now() + 0.05)
    svc.submit("cam1", window_b, priority=1)
    svc.poll()                         # non-blocking: harvest + refill
    for resp in svc.drain():           # run the queue to completion
        print(resp.stream_id, resp.seq, resp.status, resp.omega)

Design notes:

  * Bucketing bounds the executable classes: event counts pad to the
    policy's length classes and batch sizes to power-of-two classes, so a
    service holds O(#length classes x log2(max_batch)) classes. The port
    runs eagerly and compiles nothing; `stats["compiles"]` counts the
    classes built, keyed and raised exactly where the reference compiles.
  * Per-stream ordering. A stream has at most one window queued-or-
    computing per batch (warm-start chaining needs the previous result);
    concurrency comes from many streams.
  * Scheduling is injectable: a `Clock` provides time and an `Executor`
    runs batches. Production uses `MonotonicClock` +
    `AsyncDispatchExecutor`; tests drive the same state machine with
    `FakeClock` + `ManualExecutor`.
  * Batch fill. A partially full batch class is filled by replicating the
    batch leader (`data/events.py::fill_batch`); `padded_slot_frac`
    reports both event- and batch-padding.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import time
from collections import deque
from collections.abc import MutableMapping
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import Telemetry


# ---------------------------------------------------------------------------
# Injectable clocks + executors
# ---------------------------------------------------------------------------


class MonotonicClock:
    """Wall time (time.monotonic); the production clock."""

    def now(self) -> float:
        return time.monotonic()


class FakeClock:
    """Manually advanced clock for deterministic scheduler tests and
    virtual-time load generation."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        self.advance(max(0.0, float(t) - self._t))
        return self._t


def _tensors(obj) -> List[torch.Tensor]:
    """Every tensor in a batch or result (tuples, lists, dicts and
    dataclass-like objects with a `__dict__`)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif not isinstance(obj, (tuple, list)):
        obj = list(getattr(obj, "__dict__", {}).values())
    return [t for o in obj for t in _tensors(o)]


def _block(result):
    """Wait until the current stream of every device holding a tensor of
    `result` has finished its work (the port's `block_until_ready`)."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return result


@dataclasses.dataclass
class _Dispatch:
    future: concurrent.futures.Future
    done_event: Optional[torch.cuda.Event]   # None for a batch on the CPU


class AsyncDispatchExecutor:
    """The production executor: one worker thread, its own CUDA stream.

    `estimate_batch` blocks its calling thread (the residence loop reads a
    stop flag back from the device once per iteration), so a plain call
    would finish every batch before `submit` returned. `submit` instead
    hands the batch to a single worker thread and returns at once; the
    worker runs it under a stream of its own and records an event after
    it. One worker keeps batches on the device in submit order while the
    caller builds and admits the next batch. `done` polls the future and
    the event without blocking; `wait` blocks on both.

    The batch's tensors were made on the caller's stream: the worker's
    stream waits for that stream's work up to `submit`, and each tensor is
    marked as used by the worker's stream (`record_stream`), so the caching
    allocator does not hand its memory back to the caller's stream while
    the worker may still read it. Results are written on the worker's
    stream and read by the caller only after `wait` has synchronized the
    event. A batch on the CPU runs on the worker thread with no stream.
    """

    needs_data = True   # the service must materialize the padded batch

    def __init__(self):
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _worker_stream(self, dev: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(device=dev)
        return s

    def submit(self, fn, ev_batch, om_batch, bucket_n: int, batch_b: int):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="repro_torch-dispatch")
        cuda = [t for t in _tensors((ev_batch, om_batch)) if t.is_cuda]
        if not cuda:
            return _Dispatch(self._pool.submit(fn, ev_batch, om_batch), None)
        dev = cuda[0].device
        worker = self._worker_stream(dev)
        inputs_ready = torch.cuda.Event()
        inputs_ready.record(torch.cuda.current_stream(dev))
        for t in cuda:
            t.record_stream(worker)
        done_event = torch.cuda.Event()

        def run():
            with torch.cuda.stream(worker):
                worker.wait_event(inputs_ready)
                out = fn(ev_batch, om_batch)
                done_event.record(worker)
            return out

        return _Dispatch(self._pool.submit(run), done_event)

    def done(self, handle: _Dispatch) -> bool:
        if not handle.future.done():
            return False
        if handle.future.exception() is not None:
            return True               # `wait` raises it
        return handle.done_event is None or handle.done_event.query()

    def wait(self, handle: _Dispatch):
        out = handle.future.result()
        if handle.done_event is not None:
            handle.done_event.synchronize()
        return out

    def close(self) -> None:
        """Stop the worker thread once the batches submitted have run."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class InlineExecutor:
    """Synchronous executor: computes at submit, always done. Used where
    determinism matters more than overlap (tests, exact-equivalence
    checks)."""

    needs_data = True

    def submit(self, fn, ev_batch, om_batch, bucket_n: int, batch_b: int):
        return _block(fn(ev_batch, om_batch))

    def done(self, handle) -> bool:
        return True

    def wait(self, handle):
        return handle


class ManualExecutor:
    """Deterministic test executor: computes the real result at submit
    but holds completion until the test calls `release` — so tests can
    walk the admission/in-flight/refill state machine one transition at a
    time, including out-of-order batch completion."""

    needs_data = True

    def __init__(self):
        self._results: Dict[int, object] = {}
        self._released: set = set()
        self._next = 0

    def submit(self, fn, ev_batch, om_batch, bucket_n: int, batch_b: int):
        h = self._next
        self._next += 1
        self._results[h] = _block(fn(ev_batch, om_batch))
        return h

    def release(self, handle: Optional[int] = None) -> None:
        """Mark one in-flight batch (or all, when handle is None) done."""
        if handle is None:
            self._released.update(self._results.keys())
        else:
            if handle not in self._results:
                raise KeyError(f"unknown handle {handle}")
            self._released.add(handle)

    def in_flight(self) -> List[int]:
        return sorted(set(self._results) - self._released)

    def done(self, handle) -> bool:
        return handle in self._released

    def wait(self, handle):
        self._released.add(handle)    # a blocking wait forces completion
        return self._results[handle]


# ---------------------------------------------------------------------------
# Requests / responses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QosClass:
    """Per-request service class: how much each window is allowed to cost.

    Budgets are *modelled* per-window costs under the service's cost model
    (costmodel.BudgetScheduler over an HwParams profile) — joules and/or
    milliseconds of engine time on the modelled datapath, not wall time on
    this host or the card. A class with neither budget set ("standard")
    leaves the adaptive controller alone. Within one dispatched batch, the
    budgets of same-class windows are pooled.

    `strict` makes the budget an admission test as well as a cap: a
    request whose modelled FLOOR cost (min_iters per stage) already
    exceeds the budget is refused at submit (status="refused", counted
    as a budget shed) instead of being served at the floor and
    overspending. Non-strict budgeted classes — the default — always
    serve at least the floor."""
    name: str
    budget_uj: Optional[float] = None   # per-window energy budget
    budget_ms: Optional[float] = None   # per-window modelled-latency budget
    strict: bool = False                # refuse windows whose floor exceeds it

    @property
    def budgeted(self) -> bool:
        return self.budget_uj is not None or self.budget_ms is not None


@dataclasses.dataclass(frozen=True)
class WindowRequest:
    """One queued estimation request: a single variable-length window."""
    stream_id: str
    seq: int                 # per-stream sequence number (assigned by submit)
    window: object           # 1-D EventWindow
    bucket_n: int            # length class (computed once at submit)
    omega_hint: Optional[np.ndarray] = None   # overrides the warm start
    priority: int = 0        # higher is served first (FIFO within a class)
    deadline: Optional[float] = None   # absolute clock time; None = no SLO
    t_submit: float = 0.0    # clock time of submission
    order: int = 0           # global arrival index (FIFO tiebreak)
    qos: str = "standard"    # QosClass name (validated at submit)


@dataclasses.dataclass(frozen=True)
class WindowResponse:
    stream_id: str
    seq: int
    omega: np.ndarray        # (3,) float32 estimate ("ok") / last warm start
    iters: Tuple[int, ...]   # adaptive iterations per stage (() when shed)
    bucket_n: int            # event-length class the request ran in
    batch_b: int             # batch class the request ran in (0 when shed)
    status: str = "ok"       # "ok" | "shed" (deadline) | "refused" (budget)
    t_submit: float = 0.0
    t_done: float = 0.0
    qos: str = "standard"    # QosClass the request was served under

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class _InFlight:
    requests: List[WindowRequest]
    handle: object
    bucket_n: int
    batch_b: int
    t_dispatch: float
    caps: Optional[np.ndarray] = None   # (B, S) budget caps, for telemetry


# ---------------------------------------------------------------------------
# Telemetry backing: metric families + the `stats` view
# ---------------------------------------------------------------------------


class _ServingMetrics:
    """The serving layer's metric families on one registry (DESIGN.md §6
    naming: ``repro_serving_<what>_<unit>[_total]``, the reference's
    names). Both services register the same families — registration is
    create-or-get, so two services may share a registry — and the `stats`
    views of both derive from these counters."""

    def __init__(self, registry):
        self.registry = registry
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.windows = c("repro_serving_windows_total",
                         "requests served to completion")
        self.batches = c("repro_serving_batches_total", "batches dispatched")
        self.compiles = c("repro_serving_compiles_total",
                          "executable-cache misses (new shape classes)")
        self.event_slots = c("repro_serving_event_slots_total",
                             "padded slots dispatched (bucket_n * batch_b)")
        self.raw_events = c("repro_serving_raw_events_total",
                            "real payload slots dispatched")
        self.fill_slots = c("repro_serving_fill_slots_total",
                            "leader-replicated batch fill slots")
        shed = c("repro_serving_shed_total",
                 "requests dropped unserved, by reason",
                 labels=("reason",))
        self.shed_deadline = shed.labels(reason="deadline")
        self.shed_budget = shed.labels(reason="budget")
        self.budgeted_windows = c("repro_serving_budgeted_windows_total",
                                  "windows served under a QoS budget")
        self.budget_spent_uj = c("repro_serving_budget_spent_uj_total",
                                 "modelled energy bought by the scheduler")
        self.queue_wait = h("repro_serving_queue_wait_seconds",
                            "submit -> batch admission wait")
        self.execute = h("repro_serving_execute_seconds",
                         "dispatch -> harvest time of the request's batch")
        self.queue_depth = g("repro_serving_queue_depth",
                             "requests queued, not yet dispatched")
        self.inflight_batches = g("repro_serving_inflight_batches",
                                  "batches dispatched, not yet harvested")


#: `stats` key -> _ServingMetrics attribute ("shed" is derived)
_ASYNC_STAT_KEYS = ("windows", "batches", "compiles", "event_slots",
                    "raw_events", "fill_slots", "shed", "budgeted_windows",
                    "budget_spent_uj")
_SYNC_STAT_KEYS = ("windows", "batches", "compiles", "event_slots",
                   "raw_events", "fill_slots")


class _StatsView(MutableMapping):
    """The `svc.stats` dict, as a live view over the registry.

    `stats["k"] += v` routes to the backing counter — except "shed", the
    derived sum of the deadline and budget shed counters, read-only."""

    def __init__(self, metrics: _ServingMetrics, keys: Tuple[str, ...]):
        self._m = metrics
        self._keys = keys

    def __getitem__(self, k):
        if k not in self._keys:
            raise KeyError(k)
        if k == "shed":
            return (self._m.shed_deadline.value + self._m.shed_budget.value)
        return getattr(self._m, k).value

    def __setitem__(self, k, v):
        if k == "shed":
            raise TypeError("stats['shed'] is derived (deadline + budget "
                            "sheds) — write the repro_serving_shed_total "
                            "series instead")
        if k not in self._keys:
            raise KeyError(k)
        getattr(self._m, k).set(v)

    def __delitem__(self, k):
        raise TypeError("stats keys are fixed")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __repr__(self):
        return repr(dict(self))


def _batch_class(b: int, max_batch: int, mesh) -> int:
    """Pad a raw batch size to its power-of-two class (mesh-divisible)."""
    from ..data.events import _next_pow2
    cls = min(max_batch, _next_pow2(b))
    if mesh is not None:
        from ..core.distributed import _dp_extent
        ndev = _dp_extent(mesh)
        cls = max(cls, ndev)
        cls += (-cls) % ndev
    return cls


def _workload(cfg, workload, **kw):
    from ..serving.workload import CmaxWorkload, Workload
    if workload is None and isinstance(cfg, Workload):
        workload = cfg
    if workload is None:
        workload = CmaxWorkload(cfg, **kw)
    return workload


# ---------------------------------------------------------------------------
# The async continuous-batching service (DESIGN.md §Serving)
# ---------------------------------------------------------------------------


class AsyncBatchedEstimationService:
    """Admission -> bucket -> in-flight -> refill -> completion loop.

    Parameters:
      cfg: CmaxConfig — the default-workload shorthand. A
        `repro_torch.serving.Workload` instance may be passed here (or via
        `workload=`) instead; `policy`, `scheduler` and `device` then come
        from the plugin.
      policy: events.BucketPolicy mapping raw event counts to length
        classes (default: power-of-two buckets from 512). CMAX shorthand.
      max_batch: largest batch class; smaller batches pad to the next
        power of two.
      mesh: optional `launch.mesh.DeviceGrid` — CMAX batches then run
        through `core.distributed.estimate_batch_sharded` (batch classes
        kept divisible by the grid's data-parallel extent).
      clock: time source (default MonotonicClock). Deadlines are absolute
        values on this clock.
      executor: batch runner (default AsyncDispatchExecutor).
      max_in_flight: dispatch depth — how many batches may be in flight
        before admission pauses (2 = one computing + one queued).
      device: where the default CmaxWorkload builds its batches (default:
        the card).
      workload: the `Workload` plugin to serve.

    The drive loop is `poll()`: harvest every finished in-flight batch
    (any order), shed queued requests whose deadline has passed, then
    launch new batches until the in-flight window is full or nothing is
    admissible. `poll` never blocks; `drain()` polls to completion,
    blocking on the oldest in-flight batch when otherwise idle.
    """

    def __init__(self, cfg=None, policy=None, max_batch: int = 8, mesh=None,
                 clock=None, executor=None, max_in_flight: int = 2,
                 qos_classes=None, scheduler=None, workload=None,
                 telemetry: Optional[Telemetry] = None, device=None):
        workload = _workload(cfg, workload, policy=policy, mesh=mesh,
                             scheduler=scheduler, device=device)
        self.workload = workload
        self.cfg = getattr(workload, "cfg", cfg)
        self.policy = workload.policy
        self.max_batch = int(max_batch)
        self.mesh = getattr(workload, "mesh", None)
        self.clock = clock or MonotonicClock()
        self.executor = executor or AsyncDispatchExecutor()
        self.max_in_flight = int(max_in_flight)
        # telemetry: the registry is always on (it backs `stats`); span
        # tracing and decision logging are Null no-ops unless the caller's
        # Telemetry enables them (DESIGN.md §6)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.telemetry.bind_clock(self.clock)
        self._m = _ServingMetrics(self.telemetry.registry)
        self._tracer = self.telemetry.tracer
        self._decisions = self.telemetry.decisions
        self._stats = _StatsView(self._m, _ASYNC_STAT_KEYS)
        self.qos_classes: Dict[str, QosClass] = {
            "standard": QosClass("standard")}
        for q in (qos_classes or ()):
            self.qos_classes[q.name] = q
        if any(q.budgeted for q in self.qos_classes.values()) \
                and not workload.supports_budgets:
            raise ValueError(workload.budget_unsupported_msg)
        self._queue: List[WindowRequest] = []   # arrival order
        self._seq: Dict[str, int] = {}
        self._warm: Dict[str, object] = {}      # per-stream carried state
        self._gain: Dict[str, float] = {}       # measured Eq. 7 gain / stream
        self._busy: set = set()                 # streams with a window in flight
        self._inflight: Deque[_InFlight] = deque()
        self._ready: List[WindowResponse] = []
        self._order = 0
        self._cache: Dict[Tuple[int, int, bool], object] = {}

    @property
    def stats(self):
        """The accounting dict, a live view over the metrics registry
        (`telemetry.registry`)."""
        return self._stats

    # -- request side --------------------------------------------------------

    def submit(self, stream_id: str, window, omega_hint=None,
               priority: int = 0, deadline: Optional[float] = None,
               qos: str = "standard") -> int:
        """Enqueue one window for `stream_id`; returns its sequence number.

        Windows of one stream must be submitted in time order; they are
        estimated in that order with warm-start chaining. `deadline` is an
        absolute time on the service clock: a request still queued past
        its deadline is shed (status="shed") instead of computed. `qos`
        names one of the service's QosClass entries; budgeted classes run
        under scheduler-allocated iteration caps.
        """
        # bucketing at submit time rejects unservable sizes immediately —
        # a poison request must never sit in the queue
        bucket_n = self.workload.bucket_of(window)
        if qos not in self.qos_classes:
            raise ValueError(f"unknown QoS class {qos!r} "
                             f"(have {sorted(self.qos_classes)})")
        seq = self._seq.get(stream_id, 0)
        self._seq[stream_id] = seq + 1
        now = self.clock.now()
        q = self.qos_classes[qos]
        if q.strict and self.workload.unaffordable(
                window, q, self._gain.get(stream_id)):
            # strict class: even the floor execution exceeds the budget —
            # refuse now rather than overspend. The stream's warm-start
            # chain skips the window, exactly like a deadline shed.
            self._m.shed_budget.inc()
            self._tracer.start(stream_id, seq, qos, bucket_n, t=now)
            self._tracer.finish(stream_id, seq, "shed", "refused", t=now)
            out = self.workload.shed_output(self._warm.get(stream_id))
            self._ready.append(WindowResponse(
                stream_id, seq, out, (), bucket_n, 0, status="refused",
                t_submit=now, t_done=now, qos=qos))
            return seq
        hint = self.workload.coerce_hint(omega_hint)
        self._tracer.start(stream_id, seq, qos, bucket_n, t=now)
        self._queue.append(WindowRequest(
            stream_id, seq, window, bucket_n, hint, int(priority),
            None if deadline is None else float(deadline),
            now, self._order, qos))
        self._order += 1
        return seq

    def pending(self) -> int:
        return len(self._queue)

    def in_flight(self) -> int:
        """Requests currently dispatched and not yet harvested."""
        return sum(len(fb.requests) for fb in self._inflight)

    # -- executable cache ----------------------------------------------------

    def _executable(self, bucket_n: int, batch_b: int,
                    budgeted: bool = False):
        """The batch function for one (length, batch) class, built by the
        workload's executable factory; a new class raises `compiles`.

        Budgeted batches are a separate class (the iteration caps are an
        extra (B, S) operand) — but caps are data, so every allocation of
        that shape class shares one entry."""
        key = (bucket_n, batch_b, budgeted)
        fn = self._cache.get(key)
        if fn is None:
            fn = self.workload.executable(bucket_n, batch_b,
                                          budgeted=budgeted)
            self._cache[key] = fn
            self._m.compiles.inc()
        return fn

    # -- QoS: budget -> per-slot iteration caps -------------------------------

    def _allocate_caps(self, batch: List[WindowRequest],
                       batch_b: int) -> Optional[np.ndarray]:
        """Per-slot work caps for one formed batch, or None when every
        member is standard."""
        if not any(self.qos_classes[r.qos].budgeted for r in batch):
            return None
        return self.workload.allocate_caps(batch, batch_b, self.qos_classes,
                                           self._gain, self.stats)

    # -- scheduling: shed / admit / launch ------------------------------------

    def _shed_expired(self) -> None:
        """Drop queued requests whose deadline has passed. The shed notice
        is emitted immediately (it never waits behind compute); the
        stream's warm-start chain simply skips the shed window."""
        now = self.clock.now()
        keep = []
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                self._m.shed_deadline.inc()
                self._m.queue_wait.observe(now - r.t_submit)
                self._tracer.finish(r.stream_id, r.seq, "shed", "shed",
                                    t=now)
                out = self.workload.shed_output(self._warm.get(r.stream_id))
                self._ready.append(WindowResponse(
                    r.stream_id, r.seq, out, (), r.bucket_n, 0,
                    status="shed", t_submit=r.t_submit, t_done=now,
                    qos=r.qos))
            else:
                keep.append(r)
        self._queue = keep

    def _admissible(self) -> List[WindowRequest]:
        """The oldest pending window of every non-busy stream."""
        oldest: Dict[str, WindowRequest] = {}
        for r in self._queue:     # arrival order == seq order per stream
            if r.stream_id not in self._busy:
                oldest.setdefault(r.stream_id, r)
        return list(oldest.values())

    def _launch_one(self) -> bool:
        """Form and dispatch one batch: the highest-priority (then oldest)
        admissible request leads and fixes the length class; admissible
        same-class requests join in priority order up to max_batch."""
        cands = self._admissible()
        if not cands:
            return False
        cands.sort(key=lambda r: (-r.priority, r.order))
        leader = cands[0]
        bucket_n = leader.bucket_n
        batch = [r for r in cands if r.bucket_n == bucket_n][:self.max_batch]
        batch_b = _batch_class(len(batch), self.max_batch, self.mesh)

        taken = {id(r) for r in batch}
        self._queue = [r for r in self._queue if id(r) not in taken]
        t_admit = self.clock.now()
        for r in batch:
            self._busy.add(r.stream_id)
            self._m.queue_wait.observe(t_admit - r.t_submit)
            self._tracer.mark(r.stream_id, r.seq, "admit", t=t_admit)

        n_fill = batch_b - len(batch)
        caps = self._allocate_caps(batch, batch_b)
        if getattr(self.executor, "needs_data", True):
            states = [r.omega_hint if r.omega_hint is not None
                      else self._warm.get(r.stream_id,
                                          self.workload.default_state())
                      for r in batch]
            ev_batch, om_batch, n_fill = self.workload.make_batch(
                [r.window for r in batch], states, bucket_n, batch_b)
        else:
            ev_batch = om_batch = None    # virtual-time simulation

        pre_compiles = self._m.compiles.value
        fn = self._executable(bucket_n, batch_b, budgeted=caps is not None)
        compiled = self._m.compiles.value != pre_compiles
        if caps is not None:
            # the caps are per-dispatch data; the workload closes them over
            # so every executor sees the uniform fn(data, state) signature
            fn = self.workload.attach_caps(fn, caps)
        handle = self.executor.submit(fn, ev_batch, om_batch,
                                      bucket_n, batch_b)
        t_dispatch = self.clock.now()
        for r in batch:
            self._tracer.mark(r.stream_id, r.seq, "dispatch", t=t_dispatch,
                              batch_b=batch_b, compile=compiled)
        self._inflight.append(_InFlight(batch, handle, bucket_n, batch_b,
                                        t_dispatch, caps))
        self._m.batches.inc()
        self._m.event_slots.inc(bucket_n * batch_b)
        self._m.raw_events.inc(sum(self.workload.size_of(r.window)
                                   for r in batch))
        self._m.fill_slots.inc(n_fill)
        return True

    # -- completion ------------------------------------------------------------

    def _finish(self, fb: _InFlight) -> None:
        res = self.executor.wait(fb.handle)
        now = self.clock.now()
        track_gain = any(q.budgeted for q in self.qos_classes.values())
        slot = self.workload.harvest(res, track_gain)
        meta = self.workload.decision_meta(res) \
            if self._decisions.enabled else None
        for i, r in enumerate(fb.requests):
            out, state, iters, gain = slot(i)
            if state is not None:    # None = data-free run; keep old state
                self._warm[r.stream_id] = state
            self._busy.discard(r.stream_id)
            if gain is not None:
                # measured gain feeds the budget scheduler's model for
                # this stream's NEXT window (measurement -> allocation)
                self._gain[r.stream_id] = gain
            self._m.execute.observe(now - fb.t_dispatch)
            self._tracer.finish(r.stream_id, r.seq, "harvest", "ok",
                                iters=iters, t=now)
            if self._decisions.enabled:
                self._record_decisions(r, iters, fb.caps, i, meta)
            self._ready.append(WindowResponse(
                r.stream_id, r.seq, out, iters,
                fb.bucket_n, fb.batch_b, status="ok",
                t_submit=r.t_submit, t_done=now, qos=r.qos))
        self._m.windows.inc(len(fb.requests))

    def _record_decisions(self, r: WindowRequest, iters: Tuple[int, ...],
                          caps: Optional[np.ndarray], i: int,
                          meta: Optional[dict]) -> None:
        """One decision record per stage of one served window: iterations
        spent vs the budget cap and static bound, the measured stage gain,
        and the run/cap/max/skip verdict. The logged iters are the very
        values the response carries."""
        from ..core.adaptive import residence_verdict
        gains = meta["gains"] if meta is not None else None
        max_iters = meta["max_iters"] if meta is not None else None
        for s, it in enumerate(iters):
            cap = int(caps[i, s]) if caps is not None else None
            mi = int(max_iters[s]) if max_iters is not None else None
            g = float(gains[i, s]) if gains is not None else None
            self._decisions.record(
                r.stream_id, r.seq, s, int(it), cap, mi, g,
                residence_verdict(it, cap, mi))

    def _harvest(self, block: bool = False) -> bool:
        """Collect every finished in-flight batch (in any completion
        order — slot refill does not wait for older batches). When `block`
        and nothing has finished, wait on the oldest in-flight batch."""
        if block and self._inflight and \
                not any(self.executor.done(fb.handle)
                        for fb in self._inflight):
            self.executor.wait(self._inflight[0].handle)
        progressed = False
        still: Deque[_InFlight] = deque()
        for fb in self._inflight:
            if self.executor.done(fb.handle):
                self._finish(fb)
                progressed = True
            else:
                still.append(fb)
        self._inflight = still
        return progressed

    # -- drive loop -------------------------------------------------------------

    def poll(self) -> List[WindowResponse]:
        """One non-blocking scheduler turn: harvest finished batches, shed
        expired requests, refill the in-flight window from the queue.
        Returns the responses completed since the last call."""
        self._harvest(block=False)
        self._shed_expired()
        while len(self._inflight) < self.max_in_flight and self._launch_one():
            pass
        self._m.queue_depth.set(len(self._queue))
        self._m.inflight_batches.set(len(self._inflight))
        out, self._ready = self._ready, []
        return out

    def drain(self) -> List[WindowResponse]:
        """Poll until the queue and the in-flight window are both empty,
        blocking only when nothing can progress otherwise."""
        out: List[WindowResponse] = []
        while True:
            out.extend(self.poll())
            if not self._queue and not self._inflight:
                return out
            if self._inflight:
                self._harvest(block=True)

    @property
    def padded_slot_frac(self) -> float:
        """Fraction of event slots that were padding (event-length padding
        + batch-fill replication), over everything dispatched so far."""
        total = self.stats["event_slots"]
        return (total - self.stats["raw_events"]) / max(total, 1)


# ---------------------------------------------------------------------------
# Synchronous baseline: the FIFO drain, strictly sequential batches
# ---------------------------------------------------------------------------


class BatchedEstimationService:
    """Queue -> bucketed batch -> adaptive pipeline -> responses.

    Synchronous FIFO drain: `step()` blocks while its batch computes (on
    the caller's thread and stream), and nothing can be admitted
    mid-batch. See `AsyncBatchedEstimationService` for the continuous-
    batching loop with deadlines/priorities.

    Parameters are those of the async service's namesakes (`cfg` or
    `workload`, `policy`, `max_batch`, `mesh`, `device`); the clock only
    timestamps telemetry spans.
    """

    def __init__(self, cfg=None, policy=None, max_batch: int = 8, mesh=None,
                 workload=None, clock=None,
                 telemetry: Optional[Telemetry] = None, device=None):
        workload = _workload(cfg, workload, policy=policy, mesh=mesh,
                             device=device)
        self.workload = workload
        self.cfg = getattr(workload, "cfg", cfg)
        self.policy = workload.policy
        self.max_batch = int(max_batch)
        self.mesh = getattr(workload, "mesh", None)
        # the sync drain has no scheduler clock; one is carried only so
        # telemetry spans get timestamps (responses stay t=0)
        self.clock = clock or MonotonicClock()
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.telemetry.bind_clock(self.clock)
        self._m = _ServingMetrics(self.telemetry.registry)
        self._tracer = self.telemetry.tracer
        self._stats = _StatsView(self._m, _SYNC_STAT_KEYS)
        self._queue: Deque[WindowRequest] = deque()
        self._seq: Dict[str, int] = {}
        self._warm: Dict[str, object] = {}      # per-stream carried state
        self._cache: Dict[Tuple[int, int], object] = {}

    @property
    def stats(self):
        """The accounting dict, a live view over the metrics registry
        (`telemetry.registry`)."""
        return self._stats

    # -- request side ------------------------------------------------------

    def submit(self, stream_id: str, window, omega_hint=None) -> int:
        """Enqueue one window for `stream_id`; returns its sequence number.

        Windows of one stream must be submitted in time order; they are
        estimated in that order with warm-start chaining.
        """
        bucket_n = self.workload.bucket_of(window)
        seq = self._seq.get(stream_id, 0)
        self._seq[stream_id] = seq + 1
        hint = self.workload.coerce_hint(omega_hint)
        self._tracer.start(stream_id, seq, "standard", bucket_n,
                           t=self.clock.now())
        self._queue.append(
            WindowRequest(stream_id, seq, window, bucket_n, hint))
        return seq

    def pending(self) -> int:
        return len(self._queue)

    # -- executable cache --------------------------------------------------

    def _executable(self, bucket_n: int, batch_b: int):
        """The batch function for one (length, batch) class (`donate=False`
        as in the reference; in the port both give `estimate_batch`)."""
        key = (bucket_n, batch_b)
        fn = self._cache.get(key)
        if fn is None:
            fn = self.workload.executable(bucket_n, batch_b, donate=False)
            self._cache[key] = fn
            self._m.compiles.inc()
        return fn

    def _batch_class(self, b: int) -> int:
        return _batch_class(b, self.max_batch, self.mesh)

    # -- batch formation + execution ---------------------------------------

    def _collect(self) -> List[WindowRequest]:
        """FIFO batch formation: the oldest request leads, and compatible
        requests (same length class, stream not yet seen in this scan)
        join up to max_batch. Only a stream's OLDEST pending request is
        admissible; skipped requests stay queued in order."""
        if not self._queue:
            return []
        bucket = self._queue[0].bucket_n
        admitted: List[WindowRequest] = []
        seen = set()
        keep: Deque[WindowRequest] = deque()
        while self._queue:
            req = self._queue.popleft()
            if (req.stream_id not in seen and req.bucket_n == bucket):
                admitted.append(req)
                if len(admitted) == self.max_batch:
                    break   # full: the unscanned tail stays put
            else:
                keep.append(req)
            seen.add(req.stream_id)
        keep.extend(self._queue)
        self._queue = keep
        return admitted

    def step(self) -> List[WindowResponse]:
        """Drain ONE batch from the queue and return its responses
        (empty list if the queue is empty)."""
        batch = self._collect()
        if not batch:
            return []
        bucket_n = batch[0].bucket_n
        batch_b = self._batch_class(len(batch))
        t_admit = self.clock.now()
        for req in batch:
            self._tracer.mark(req.stream_id, req.seq, "admit", t=t_admit)

        states = [req.omega_hint if req.omega_hint is not None
                  else self._warm.get(req.stream_id,
                                      self.workload.default_state())
                  for req in batch]
        # fill slots replicate the leader (finite data, results discarded)
        data, state_batch, n_fill = self.workload.make_batch(
            [req.window for req in batch], states, bucket_n, batch_b)
        pre_compiles = self._m.compiles.value
        fn = self._executable(bucket_n, batch_b)
        compiled = self._m.compiles.value != pre_compiles
        t_dispatch = self.clock.now()
        for req in batch:
            self._tracer.mark(req.stream_id, req.seq, "dispatch",
                              t=t_dispatch, batch_b=batch_b,
                              compile=compiled)
        res = _block(fn(data, state_batch))
        t_done = self.clock.now()
        self._m.execute.observe(t_done - t_dispatch)

        slot = self.workload.harvest(res, False)
        out = []
        for i, req in enumerate(batch):
            out_i, state, iters, _ = slot(i)
            if state is not None:
                self._warm[req.stream_id] = state
            self._tracer.finish(req.stream_id, req.seq, "harvest", "ok",
                                iters=iters, t=t_done)
            out.append(WindowResponse(
                stream_id=req.stream_id, seq=req.seq, omega=out_i,
                iters=iters, bucket_n=bucket_n, batch_b=batch_b))

        self._m.windows.inc(len(batch))
        self._m.batches.inc()
        self._m.event_slots.inc(bucket_n * batch_b)
        self._m.raw_events.inc(sum(self.workload.size_of(req.window)
                                   for req in batch))
        self._m.fill_slots.inc(n_fill)
        return out

    def drain(self) -> List[WindowResponse]:
        """Run `step` until the queue is empty; responses in batch order."""
        out: List[WindowResponse] = []
        while self._queue:
            out.extend(self.step())
        return out

    @property
    def padded_slot_frac(self) -> float:
        """Fraction of event slots that were padding (event-length padding
        + batch-fill replication), over everything served so far."""
        total = self.stats["event_slots"]
        return (total - self.stats["raw_events"]) / max(total, 1)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli_telemetry(args) -> Telemetry:
    """Telemetry for a CLI run: spans + decisions when a trace sink is
    requested; the registry is always on."""
    want_trace = getattr(args, "trace_out", None) is not None
    return Telemetry(spans=want_trace, decisions=want_trace)


def _cli_export(svc, args) -> None:
    """Write --metrics-out / --trace-out artifacts and print the human
    summary when either was requested."""
    tel = svc.telemetry
    if getattr(args, "metrics_out", None):
        tel.write_metrics(args.metrics_out)
        print(f"wrote Prometheus metrics to {args.metrics_out}")
    if getattr(args, "trace_out", None):
        n = tel.write_trace(args.trace_out)
        print(f"wrote {n} trace records (spans + decisions) "
              f"to {args.trace_out}")
    if getattr(args, "metrics_out", None) or \
            getattr(args, "trace_out", None):
        print(tel.summary(), end="")


def _run_cmax(args) -> None:
    from ..core import CmaxConfig
    from ..data import events as ev_data

    cfg = dataclasses.replace(CmaxConfig(), engine=args.engine,
                              engine_capacity=args.engine_capacity)
    cam = cfg.camera
    if args.policy == "pow2":
        policy = ev_data.pow2_policy(min_bucket=args.min_bucket)
    else:
        policy = ev_data.single_policy(args.max_events)

    budgeted = args.budget_uj is not None or args.budget_ms is not None
    if args.strict_budget and not budgeted:
        raise SystemExit("--strict-budget needs --budget-uj/--budget-ms")
    tel = _cli_telemetry(args)
    if args.sync:
        if budgeted:
            raise SystemExit("--budget-uj/--budget-ms need the async "
                             "service (drop --sync)")
        svc = BatchedEstimationService(cfg, policy=policy,
                                       max_batch=args.max_batch,
                                       telemetry=tel, device=args.device)
    else:
        qos = []
        if budgeted:
            qos.append(QosClass("budgeted", budget_uj=args.budget_uj,
                                budget_ms=args.budget_ms,
                                strict=args.strict_budget))
        svc = AsyncBatchedEstimationService(cfg, policy=policy,
                                            max_batch=args.max_batch,
                                            qos_classes=qos,
                                            telemetry=tel, device=args.device)

    # synthetic ragged workload: S streams x K windows, log-uniform lengths
    truth = {}
    for s in range(args.streams):
        spec = ev_data.SequenceSpec(
            name=f"s{s}", n_windows=args.windows,
            events_per_window=args.max_events, seed=100 + s, camera=cam,
            omega_scale=3.0, window_dt=0.02)
        wins, om_true, _ = ev_data.make_sequence(spec, device=args.device)
        lens = ev_data.ragged_lengths(args.windows, args.min_events,
                                      args.max_events, seed=s)
        ragged = ev_data.ragged_from_sequence(wins, lens)
        truth[f"s{s}"] = om_true.cpu().numpy()
        for k, w in enumerate(ragged):
            svc.submit(f"s{s}", w,
                       omega_hint=truth[f"s{s}"][0] if k == 0 else None,
                       **({"qos": "budgeted"} if budgeted else {}))

    n_req = svc.pending()
    t0 = time.perf_counter()
    try:
        responses = svc.drain()
    finally:
        if not args.sync:
            svc.executor.close()
    dt = time.perf_counter() - t0

    errs = [float(np.linalg.norm(r.omega - truth[r.stream_id][r.seq]))
            for r in responses]
    mode = "sync FIFO drain" if args.sync else "async continuous batching"
    where = torch.cuda.get_device_name(svc.workload.device) \
        if svc.workload.device.type == "cuda" else "cpu"
    print(f"served {len(responses)}/{n_req} windows in {dt:.2f}s "
          f"({len(responses) / dt:.2f} windows/s, {mode}, engine "
          f"{cfg.engine}, on {where})")
    print(f"batches={svc.stats['batches']} compiles={svc.stats['compiles']} "
          f"padded_slot_frac={svc.padded_slot_frac:.3f} "
          f"policy={svc.policy.name}")
    if not args.sync:
        lats = sorted(r.latency for r in responses)
        p50 = lats[len(lats) // 2]
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        print(f"latency p50={1e3 * p50:.1f}ms p99={1e3 * p99:.1f}ms "
              f"shed={svc.stats['shed']}")
        if budgeted:
            per_w = svc.stats["budget_spent_uj"] / max(
                svc.stats["budgeted_windows"], 1)
            print(f"budgeted_windows={svc.stats['budgeted_windows']} "
                  f"modelled spend={per_w:.2f} uJ/window")
    print(f"rmse vs ground truth: "
          f"{float(np.sqrt(np.mean(np.square(errs)))):.4f} rad/s")
    _cli_export(svc, args)


def _run_lm(args) -> None:
    from ..configs import get_smoke_config
    from ..data import lm as lm_data
    from ..serving import LMDecodeWorkload

    cfg = get_smoke_config(args.arch)
    policy = lm_data.chunk_policy(min_bucket=args.min_bucket)
    wl = LMDecodeWorkload(cfg, policy=policy, max_len=args.max_len,
                          device=args.device)
    tel = _cli_telemetry(args)
    if args.sync:
        svc = BatchedEstimationService(workload=wl,
                                       max_batch=args.max_batch,
                                       telemetry=tel)
    else:
        svc = AsyncBatchedEstimationService(workload=wl,
                                            max_batch=args.max_batch,
                                            telemetry=tel)

    data_cfg = lm_data.LMDataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.max_tokens,
                                    global_batch=1, seed=0)
    streams = lm_data.token_streams(data_cfg, args.streams, args.chunks,
                                    args.min_tokens, args.max_tokens)
    n_tok = 0
    for sid, chunks in streams.items():
        for c in chunks:
            svc.submit(sid, c)
            n_tok += c.n

    n_req = svc.pending()
    t0 = time.perf_counter()
    try:
        responses = svc.drain()
    finally:
        if not args.sync:
            svc.executor.close()
    dt = time.perf_counter() - t0
    mode = "sync FIFO drain" if args.sync else "async continuous batching"
    where = torch.cuda.get_device_name(wl.device) \
        if wl.device.type == "cuda" else "cpu"
    print(f"{cfg.name}: served {len(responses)}/{n_req} chunks "
          f"({n_tok} tokens) from {args.streams} streams in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl model build, {mode}, on {where})")
    print(f"batches={svc.stats['batches']} compiles={svc.stats['compiles']} "
          f"padded_slot_frac={svc.padded_slot_frac:.3f} "
          f"policy={svc.policy.name}")
    first = min(responses, key=lambda r: (r.stream_id, r.seq))
    preds = np.asarray(first.omega)
    print(f"greedy continuation ids ({first.stream_id} chunk 0, "
          f"first {min(16, preds.size)}):", preds[:16].tolist())
    _cli_export(svc, args)


def main(argv=None):
    from ..core.types import CmaxConfig, ENGINES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)

    cm = sub.add_parser("cmax", help="batched CMAX estimation service demo")
    cm.add_argument("--streams", type=int, default=4)
    cm.add_argument("--windows", type=int, default=4)
    cm.add_argument("--min-events", type=int, default=1024)
    cm.add_argument("--max-events", type=int, default=4096)
    cm.add_argument("--min-bucket", type=int, default=1024)
    cm.add_argument("--max-batch", type=int, default=8)
    cm.add_argument("--policy", choices=["pow2", "single"], default="pow2")
    cm.add_argument("--engine", choices=list(ENGINES),
                    default=CmaxConfig().engine,
                    help="engine-pass backend: reference (plain PyTorch "
                         "oracle), cuda (per-window tile-accumulation and "
                         "blur-statistics kernels), or cuda_batched (one "
                         "engine-pass kernel call per batch engine pass; "
                         "the default)")
    cm.add_argument("--engine-capacity", type=int, default=4096,
                    help="per-tile tap budget of the cuda engine's "
                         "accumulation kernel (taps beyond it are folded "
                         "back in: speed, not the result)")
    cm.add_argument("--sync", action="store_true",
                    help="use the synchronous FIFO-drain baseline")
    cm.add_argument("--budget-uj", type=float, default=None,
                    help="per-window energy budget (uJ, paper_fpga_45nm "
                         "cost model) — serves everything under a "
                         "budgeted QoS class")
    cm.add_argument("--budget-ms", type=float, default=None,
                    help="per-window modelled-latency budget (ms)")
    cm.add_argument("--strict-budget", action="store_true",
                    help="refuse (status=refused) windows whose modelled "
                         "floor cost already exceeds the budget instead "
                         "of serving them at the floor")

    lm = sub.add_parser("lm", help="LM decode served in variable-length "
                                   "token chunks through the bucketed "
                                   "async service")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--streams", type=int, default=4)
    lm.add_argument("--chunks", type=int, default=3,
                    help="chunks per stream (per-stream KV cache is "
                         "carried across them)")
    lm.add_argument("--min-tokens", type=int, default=8)
    lm.add_argument("--max-tokens", type=int, default=48)
    lm.add_argument("--min-bucket", type=int, default=16)
    lm.add_argument("--max-len", type=int, default=256,
                    help="per-stream KV cache capacity (total tokens a "
                         "stream may decode)")
    lm.add_argument("--max-batch", type=int, default=4)
    lm.add_argument("--sync", action="store_true",
                    help="use the synchronous FIFO-drain baseline")

    for p in (cm, lm):
        p.add_argument("--device", default="cuda",
                       help="where batches run: cuda (the default) or cpu "
                            "(the plain PyTorch path)")
        p.add_argument("--metrics-out", default=None, metavar="PATH",
                       help="write Prometheus text-format metrics here "
                            "after the drain")
        p.add_argument("--trace-out", default=None, metavar="PATH",
                       help="write the JSONL telemetry trace (request "
                            "spans + adaptation decisions) here; also "
                            "enables span/decision collection")

    args = ap.parse_args(argv)
    if args.mode == "cmax":
        _run_cmax(args)
    else:
        _run_lm(args)


if __name__ == "__main__":
    main()
