"""CUDA graphs of the residence loop (`pipeline._run_stage_batched`).

On the card a lockstep pass is hundreds of small PyTorch ops around the
engine's hand-written kernels, each a Python dispatch and a launch of a
few microseconds of work, so the host, not the device, sets the pace.
Here each *class* of stage runs — one device, configuration, stage index,
batch size and length — gets two graphs, captured from the loop's own
bodies (`pipeline._entry_pass`, `pipeline._lockstep_pass`):

  entry graph  the stage's sort (Alg. 3), the entry pass, the carry's
               initial value and the stop test;
  pass graph   one lockstep pass (propose, engine, select) and the stop
               test, updating the carry in place.

The host loop replays the entry graph, then the pass graph while the stop
flag it reads back is set: one replay and one device->host read a pass,
and the trip count stays on the host. A class's first batch runs the
bodies eagerly (which loads the kernel modules and warms the sorts), then
captures them on a side stream in the "thread_local" mode, so another
thread may keep copying batches to the card meanwhile; later batches
replay. A replay runs the captured kernels on the class's own buffers:
the batch's events, warm starts and iteration caps are copied in first,
and the stage's results are cloned out at its end, so a later batch of
the class never overwrites a result a caller holds. One stage run at a
time uses a class's buffers: a lock, and an event that orders the next
user's stream after the last one's clones.

The two graphs of a class share one private memory pool, which lives as
long as the process. The kernel wrappers count the launches a replay
makes (`kernels._build.count_launch`): capture counts them aside, and
every replay adds them to the wrappers' `launches`.

What the loop does on a card is counted per stage — captures, entry and
pass replays, lockstep passes run eagerly — into the counter of the
calling thread's `graph_tally`, where there is one (a service bumps its
`repro_serving_graph_*_total` families from it).
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, Optional

import torch

from ..telemetry.spans import step
from .types import CmaxConfig, EventWindow

#: engines whose residence loop runs on graphs on a card
GRAPH_ENGINES = ("cuda", "cuda_batched")

#: the counts a tally keeps, by (kind, stage)
TALLY_KINDS = ("captures", "entry_replays", "pass_replays", "eager_passes")

_TALLY_LOCK = threading.Lock()


class _Sink(threading.local):
    counts = None


_sink = _Sink()


@contextlib.contextmanager
def graph_tally(counts: Optional[collections.Counter] = None):
    """Count, inside the block, what the residence loop of the calling
    thread does on a card into `counts` (a new Counter if None), keyed by
    (kind, stage) with kind one of `TALLY_KINDS`; yields it. Threads that
    run a shard of the caller's batch share the caller's tally."""
    counts = collections.Counter() if counts is None else counts
    saved, _sink.counts = _sink.counts, counts
    try:
        yield counts
    finally:
        _sink.counts = saved


def current_tally() -> Optional[collections.Counter]:
    """The calling thread's tally, or None outside `graph_tally`."""
    return _sink.counts


def tally(kind: str, stage: int, n: int = 1) -> None:
    counts = _sink.counts
    if counts is not None:
        with _TALLY_LOCK:
            counts[(kind, stage)] += n


def _fields(ev: EventWindow):
    return (ev.x, ev.y, ev.t, ev.p, ev.valid)


@contextlib.contextmanager
def _captured(graph: torch.cuda.CUDAGraph, pool):
    """Capture the block's work on the current stream into `graph`; yields
    the launches the kernel wrappers made, which run at each replay."""
    from ..kernels import _build
    with _build.tally_launches() as launches:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield launches
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()


class StageGraphs:
    """The entry and pass graphs of one class, and the buffers they
    replay on."""

    def __init__(self, stage: int):
        self.stage = stage
        self.lock = threading.Lock()
        self.entry = self.lockstep = None
        self.free: Optional[torch.cuda.Event] = None

    @property
    def captured(self) -> bool:
        return self.lockstep is not None

    def capture(self, ev: EventWindow, omega: torch.Tensor,
                cap: torch.Tensor, entry: Callable, lockstep: Callable
                ) -> None:
        """Capture `entry(ev, omega, cap) -> lockstep state` and
        `lockstep(state, ev)` over buffers shaped as these inputs, once a
        batch of the class has run them eagerly (a no-op if another
        thread has captured the class meanwhile)."""
        with self.lock:
            if self.captured:
                return
            dev = omega.device
            new = lambda a: torch.empty(a.shape, dtype=a.dtype, device=dev)
            self.ev = EventWindow(*[new(a) for a in _fields(ev)])
            self.omega, self.cap = new(omega), new(cap)
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            entry_g, pass_g = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with step("capture", stage=self.stage), torch.cuda.stream(side):
                with _captured(entry_g, None) as entry_launches:
                    self.state = entry(self.ev, self.omega, self.cap)
                with _captured(pass_g, entry_g.pool()) as pass_launches:
                    lockstep(self.state, self.ev)
            cur.wait_stream(side)
            # the graphs read what the bodies close over (the engine's FIR
            # taps, made before the capture): keep it alive with them
            self.bodies = (entry, lockstep)
            self.entry, self.entry_launches = entry_g, entry_launches
            self.lockstep, self.pass_launches = pass_g, pass_launches
        tally("captures", self.stage)

    @contextlib.contextmanager
    def bound(self, ev: EventWindow, omega: torch.Tensor, cap: torch.Tensor):
        """Hold the class's buffers for one stage run with these inputs
        copied in (on the current stream, after the last run's clones)."""
        cur = torch.cuda.current_stream(omega.device)
        with self.lock:
            if self.free is not None:
                cur.wait_event(self.free)
            for dst, src in zip(_fields(self.ev), _fields(ev)):
                dst.copy_(src)
            self.omega.copy_(omega)
            self.cap.copy_(cap)
            yield
            self.free = torch.cuda.Event()
            self.free.record(cur)

    def _replay(self, graph: torch.cuda.CUDAGraph, launches: Dict,
                kind: str) -> None:
        from ..kernels import _build
        graph.replay()
        for wrapper, n in launches.items():
            _build.count_launch(wrapper, n)
        tally(kind, self.stage)

    def replay_entry(self):
        """Replay the entry graph; returns the lockstep state it wrote."""
        self._replay(self.entry, self.entry_launches, "entry_replays")
        return self.state

    def replay_pass(self, state) -> None:
        """Replay the pass graph (which updates `state` in place)."""
        self._replay(self.lockstep, self.pass_launches, "pass_replays")


_CLASSES: Dict[tuple, StageGraphs] = {}
_CLASSES_LOCK = threading.Lock()


def stage_graphs(ev: EventWindow, omega: torch.Tensor, cfg: CmaxConfig,
                 stage: int) -> Optional[StageGraphs]:
    """The graphs of this stage run's class, captured or not; None where
    the loop runs eagerly (off the card, or under the reference
    engine)."""
    if not omega.is_cuda or cfg.engine not in GRAPH_ENGINES:
        return None
    key = (omega.device, cfg, stage, tuple(ev.x.shape), omega.dtype,
           tuple(a.dtype for a in _fields(ev)))
    with _CLASSES_LOCK:
        graphs = _CLASSES.get(key)
        if graphs is None:
            graphs = _CLASSES[key] = StageGraphs(stage)
        return graphs
