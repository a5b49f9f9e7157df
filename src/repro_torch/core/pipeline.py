"""CMAX estimation pipeline: warp -> sort -> iterate -> promote (counterpart
of `repro.core.pipeline`).

  for each stage s in {1/4, 1/2, 1}:                     (coarse-to-fine)
      sort_events(...)            # once per stage entry (Alg. 3)
      entry pass: (V_prev, grad)  # Alg. 1 line 2
      residence loop:             # runtime-adaptive (Alg. 1)
          omega <- CG-PR(omega, grad)          # Update(omega, s)
          engine pass: IWE+dIWE -> blur -> (V, grad)     # one pass/iter
          g = (V - V_prev)/|V_prev|
          adaptive:  stay iff g >= tau_s  (else promote / terminate)
          fixed:     stay iff iter < fixed_iters[s]

The reference's `lax.while_loop` is a host loop here: every iteration reads
one stop flag back from the device (one device->host sync per iteration).
Batches run in masked lockstep (`_run_stage_batched`): one engine pass per
iteration covers the whole batch, finished windows keep their carry
verbatim, and the loop stops when no window is active — the carry-select
semantics of the reference, so a window's result does not depend on the
batch it rides in. Under engine="cuda_batched" each such pass is one call
of the engine-pass kernel for the whole batch; under engine="cuda" it is one
launch each of the tile-accumulation and blur-statistics kernels, for one
window (`estimate_window`, `estimate_sequence`) or the whole batch.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cgpr
from .contrast import gaussian_taps, stats_to_objective, streaming_stats
from .iwe import build_iwe
from .sorting import sort_events
from .types import Camera, CmaxConfig, EventWindow, StageConfig


class StageTrace(NamedTuple):
    iters: torch.Tensor        # (...) int32 — update iterations executed
    passes: torch.Tensor       # (...) int32 — engine passes (= iters + 1)
    n_retained: torch.Tensor   # (...) int32 — events retained by Alg. 3
    v_final: torch.Tensor      # (...) f32  — variance at stage exit
    v_entry: torch.Tensor      # (...) f32  — variance at stage entry
    v_history: torch.Tensor    # (..., max_iters) f32 per-iteration variance
    omega_entry: torch.Tensor  # (..., 3) hypothesis at stage entry
    omega_exit: torch.Tensor   # (..., 3) hypothesis at stage exit


class WindowResult(NamedTuple):
    omega: torch.Tensor                 # (..., 3) final estimate
    stages: Tuple[StageTrace, ...]      # one per stage


EnginePass = Callable[[EventWindow, torch.Tensor, torch.Tensor],
                      Tuple[torch.Tensor, torch.Tensor]]


def map_result(fn: Callable[[torch.Tensor], torch.Tensor],
               res: WindowResult) -> WindowResult:
    """Apply `fn` to every tensor of a result."""
    return WindowResult(
        omega=fn(res.omega),
        stages=tuple(StageTrace(*[fn(a) for a in st]) for st in res.stages))


def stack_results(results: List[WindowResult], dim: int = 0
                  ) -> WindowResult:
    """Stack results leaf by leaf along a new axis `dim`."""
    first = results[0]
    return WindowResult(
        omega=torch.stack([r.omega for r in results], dim=dim),
        stages=tuple(
            StageTrace(*[torch.stack([r.stages[si][f] for r in results],
                                     dim=dim)
                         for f in range(len(StageTrace._fields))])
            for si in range(len(first.stages))))


def _fir_cache(stage: StageConfig, dtype):
    cache = {}

    def fir(device: torch.device) -> torch.Tensor:
        if device not in cache:
            cache[device] = gaussian_taps(stage.blur_taps, stage.blur_sigma,
                                          dtype, device=device)
        return cache[device]

    return fir


def make_engine_pass(cam: Camera, stage: StageConfig,
                     dtype=torch.float32, engine: str = "reference", *,
                     capacity: int = 4096) -> EnginePass:
    """One full engine pass at stage s: warp+vote+accumulate (IWE & dIWE),
    blur statistics, Eq. 12 objective + gradient. Returns
    fn(ev, weights, omega) -> (variance, grad(..., 3)).

    "reference" is the plain datapath and takes any leading batch axes;
    "cuda" takes one (N,) window or a (B, N) batch, with `capacity` taps per
    tile in its accumulation kernel; "cuda_batched" runs one window as a
    batch of one through the kernel."""
    Hs, Ws = stage.grid(cam)
    fir = _fir_cache(stage, dtype)

    if engine == "cuda":
        from ..kernels.ops import fused_engine_pass

        def tile_engine(ev: EventWindow, weights: torch.Tensor,
                        omega: torch.Tensor):
            v, g, _spilled = fused_engine_pass(
                ev, omega, cam, stage.scale, stage.blur_taps,
                stage.blur_sigma, weights=weights, capacity=capacity,
                fir=fir(ev.device))
            return v, g

        return tile_engine
    if engine == "cuda_batched":
        from ..kernels.ops import batched_engine_pass

        def kernel_engine(ev: EventWindow, weights: torch.Tensor,
                          omega: torch.Tensor):
            v, g, _spilled = batched_engine_pass(
                ev.map(lambda a: a.unsqueeze(0)), omega.unsqueeze(0), cam,
                stage.scale, stage.blur_taps, stage.blur_sigma,
                weights=weights.unsqueeze(0), fir=fir(ev.device))
            return v[0], g[0]

        return kernel_engine
    if engine != "reference":
        raise ValueError(f"unknown engine {engine!r}")

    def reference_engine(ev: EventWindow, weights: torch.Tensor,
                         omega: torch.Tensor):
        channels = build_iwe(ev, omega, cam, stage.scale, weights=weights)
        stats = streaming_stats(channels, fir(ev.device))
        return stats_to_objective(stats, Hs * Ws)

    return reference_engine


def make_batched_engine_pass(cam: Camera, stage: StageConfig,
                             cfg: CmaxConfig) -> EnginePass:
    """Whole-batch engine pass: fn(ev (B,N), weights (B,N), omega (B,3))
    -> (variance (B,), grad (B,3)).

    Under engine="cuda_batched" this is the prologue plus ONE kernel call
    for the whole batch; "cuda" launches each of its two kernels once for
    the whole batch; "reference" runs the plain datapath on the batch."""
    if cfg.engine == "cuda_batched":
        from ..kernels.ops import batched_engine_pass
        fir = _fir_cache(stage, torch.float32)

        def kernel_engine(ev: EventWindow, weights: torch.Tensor,
                          omega: torch.Tensor):
            v, g, _spilled = batched_engine_pass(
                ev, omega, cam, stage.scale, stage.blur_taps,
                stage.blur_sigma, weights=weights, rb=cfg.engine_rb,
                fir=fir(ev.device))
            return v, g

        return kernel_engine
    return make_engine_pass(cam, stage, cfg.dtype, engine=cfg.engine,
                            capacity=cfg.engine_capacity)


def _max_iters(cfg: CmaxConfig, stage: StageConfig, stage_idx: int) -> int:
    return stage.max_iters if cfg.adaptive else int(cfg.fixed_iters[stage_idx])


def _run_stage(ev: EventWindow, omega: torch.Tensor,
               opt_state: cgpr.CgprState, cam: Camera, stage: StageConfig,
               cfg: CmaxConfig, stage_idx: int, engine: EnginePass,
               iter_cap: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, cgpr.CgprState, StageTrace]:
    """Residence of one window at one stage under Alg. 1 (or the fixed
    schedule). `iter_cap`, when given, is an int tensor bounding residence
    on top of the static `max_iters`.

    Update(omega, s) uses accept/reject step control: a proposal that
    decreases the variance is rejected (omega reverts) and the step halves;
    a stage gives up and promotes when the step has collapsed to alpha0/64.
    Every proposal, accepted or not, costs one engine pass."""
    dev = omega.device
    tables = sort_events(ev, omega, cam, stage)
    weights = tables.weights

    # Alg. 1 line 2: V_prev <- V_s(omega)  (entry pass, also primes grad)
    v_entry, g_entry = engine(ev, weights, omega)

    max_iters = _max_iters(cfg, stage, stage_idx)
    cap = max_iters if iter_cap is None else min(max_iters, int(iter_cap))

    update = cgpr.step if cfg.use_cgpr else cgpr.gradient_ascent_step
    alpha0 = torch.tensor(cfg.step_size * stage.step_scale, dtype=cfg.dtype,
                          device=dev)
    alpha_floor = alpha0 / 64.0

    om, ost, v_prev, g, alpha = omega, opt_state, v_entry, g_entry, alpha0
    hist = torch.full((max_iters,), float("nan"), dtype=v_entry.dtype,
                      device=dev)
    it, done = 0, False
    while not done and it < cap:
        om_p, ost_p = update(om, g, ost, alpha)      # propose
        v_p, g_p = engine(ev, weights, om_p)         # one engine pass
        hist[it] = v_p
        improved = v_p > v_prev
        sel = lambda a, b: torch.where(improved, a, b)
        om = sel(om_p, om)
        ost = cgpr.CgprState(*[sel(a, b) for a, b in zip(ost_p, ost)])
        g = sel(g_p, g)
        alpha = torch.where(improved, alpha, alpha * 0.5)
        if cfg.adaptive:
            g_norm = (v_p - v_prev) / torch.clamp(torch.abs(v_prev),
                                                  min=1e-12)
            stop = (improved & (g_norm < stage.tau)) | \
                ((~improved) & (alpha < alpha_floor))
        v_prev = sel(v_p, v_prev)
        it += 1
        if cfg.adaptive:
            done = bool(stop)                        # one sync/iteration

    iters = torch.tensor(it, dtype=torch.int32, device=dev)
    trace = StageTrace(iters=iters, passes=iters + 1,
                       n_retained=tables.n_retained, v_final=v_prev,
                       v_entry=v_entry, v_history=hist,
                       omega_entry=omega, omega_exit=om)
    return om, ost, trace


def _masked_select(mask: torch.Tensor, new, old):
    """Per-leaf `where` with a (B,) mask broadcast over trailing axes."""
    if isinstance(new, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    vals = [_masked_select(mask, n, o) for n, o in zip(new, old)]
    return type(new)(*vals) if hasattr(new, "_fields") else type(new)(vals)


def _run_stage_batched(ev: EventWindow, omega: torch.Tensor,
                       opt_state: cgpr.CgprState, cam: Camera,
                       stage: StageConfig, cfg: CmaxConfig, stage_idx: int,
                       engine_b: EnginePass,
                       iter_cap: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, cgpr.CgprState, StageTrace]:
    """`_run_stage` for a whole (B,·) batch in masked lockstep.

    One shared loop iterates until every window is done; each iteration is
    one batched engine pass, and finished windows keep their carry verbatim
    (masked no-ops). `iter_cap`, when given, is a (B,) int tensor."""
    B = omega.shape[0]
    dev = omega.device
    tables = sort_events(ev, omega, cam, stage)
    weights = tables.weights                              # (B, N)

    v_entry, g_entry = engine_b(ev, weights, omega)       # (B,), (B, 3)

    max_iters = _max_iters(cfg, stage, stage_idx)
    cap = torch.full((B,), max_iters, dtype=torch.int32, device=dev)
    if iter_cap is not None:
        cap = torch.minimum(cap, torch.as_tensor(iter_cap, device=dev)
                            .to(torch.int32))

    update = cgpr.step if cfg.use_cgpr else cgpr.gradient_ascent_step
    alpha0 = torch.full((B,), cfg.step_size * stage.step_scale,
                        dtype=cfg.dtype, device=dev)
    alpha_floor = alpha0 / 64.0
    rows = torch.arange(B, device=dev)
    no = torch.zeros((B,), dtype=torch.bool, device=dev)

    # hist is updated in place; every other carry leaf is masked-selected
    hist = torch.full((B, max_iters), float("nan"), dtype=v_entry.dtype,
                      device=dev)
    carry = ((omega, opt_state), v_entry, g_entry,
             torch.zeros((B,), dtype=torch.int32, device=dev), no, alpha0)
    while True:
        (om, ost), v_prev, g, it, done, alpha = carry
        active = (~done) & (it < cap)                      # (B,)
        if not bool(active.any()):                         # one sync/iter
            break
        om_p, ost_p = update(om, g, ost, alpha)            # propose (all B)
        v_p, g_p = engine_b(ev, weights, om_p)             # ONE batched pass
        it_c = it.clamp(0, max(max_iters - 1, 0)).long()
        hist[rows, it_c] = torch.where(active, v_p, hist[rows, it_c])
        improved = v_p > v_prev
        om_n = _masked_select(improved, om_p, om)
        ost_n = _masked_select(improved, ost_p, ost)
        g_n = _masked_select(improved, g_p, g)
        if cfg.adaptive:
            g_norm = (v_p - v_prev) / torch.clamp(torch.abs(v_prev),
                                                  min=1e-12)
            done_ok = improved & (g_norm < stage.tau)
        else:
            done_ok = no
        alpha_n = torch.where(improved, alpha, alpha * 0.5)
        done_stuck = ((~improved) & (alpha_n < alpha_floor)) \
            if cfg.adaptive else no
        v_prev_n = torch.where(improved, v_p, v_prev)
        # finished windows keep their carry verbatim (masked no-op)
        new = ((om_n, ost_n), v_prev_n, g_n, it + 1, done_ok | done_stuck,
               alpha_n)
        carry = _masked_select(active, new, carry)

    (om, ost), v_fin, _, iters, _, _ = carry
    trace = StageTrace(iters=iters, passes=iters + 1,
                       n_retained=tables.n_retained, v_final=v_fin,
                       v_entry=v_entry, v_history=hist,
                       omega_entry=omega, omega_exit=om)
    return om, ost, trace


def _estimate_batch_lockstep(windows: EventWindow, omega0s: torch.Tensor,
                             cfg: CmaxConfig,
                             iter_caps: Optional[torch.Tensor] = None
                             ) -> WindowResult:
    """Whole-batch estimation through the batched engine pass: every engine
    pass of every stage is one batched call covering the full batch."""
    cam = cfg.camera
    B = omega0s.shape[0]
    omega = omega0s.to(cfg.dtype)
    traces = []
    for si, stage in enumerate(cfg.stages):
        engine_b = make_batched_engine_pass(cam, stage, cfg)
        # CG restarts at each stage, as in the per-window path.
        opt_state = cgpr.init_state(3, cfg.dtype, device=omega.device,
                                    batch=(B,))
        omega, opt_state, tr = _run_stage_batched(
            windows, omega, opt_state, cam, stage, cfg, si, engine_b,
            iter_cap=None if iter_caps is None else iter_caps[:, si])
        traces.append(tr)
    return WindowResult(omega=omega, stages=tuple(traces))


def _squeeze0(res: WindowResult) -> WindowResult:
    return map_result(lambda a: a[0], res)


def _estimate_window(ev: EventWindow, omega0: torch.Tensor, cfg: CmaxConfig,
                     iter_caps: Optional[torch.Tensor]) -> WindowResult:
    if cfg.engine == "cuda_batched":
        # B=1 batch through the kernel path, squeezed back to scalars.
        caps = None if iter_caps is None else iter_caps.unsqueeze(0)
        return _squeeze0(_estimate_batch_lockstep(
            ev.map(lambda a: a.unsqueeze(0)), omega0.unsqueeze(0), cfg,
            iter_caps=caps))
    cam = cfg.camera
    omega = omega0.to(cfg.dtype)
    traces = []
    for si, stage in enumerate(cfg.stages):
        engine = make_engine_pass(cam, stage, cfg.dtype, engine=cfg.engine,
                                  capacity=cfg.engine_capacity)
        # CG history does not transfer across resolutions (the objective
        # surface changes scale) — restart CG at each stage, as HW does.
        opt_state = cgpr.init_state(3, cfg.dtype, device=omega.device)
        omega, opt_state, tr = _run_stage(
            ev, omega, opt_state, cam, stage, cfg, si, engine,
            iter_cap=None if iter_caps is None else iter_caps[si])
        traces.append(tr)
    return WindowResult(omega=omega, stages=tuple(traces))


def estimate_window(ev: EventWindow, omega0: torch.Tensor,
                    cfg: CmaxConfig) -> WindowResult:
    """Estimate the rotation rate for one (N,) event window (warm-started
    at omega0 (3,))."""
    return _estimate_window(ev, omega0, cfg, None)


def estimate_window_budgeted(ev: EventWindow, omega0: torch.Tensor,
                             iter_caps: torch.Tensor, cfg: CmaxConfig
                             ) -> WindowResult:
    """`estimate_window` under a per-stage iteration allocation.

    `iter_caps` is an (n_stages,) int tensor of caps. The adaptive gain
    test still terminates a stage early; caps >= stage.max_iters reproduce
    `estimate_window` exactly."""
    return _estimate_window(ev, omega0, cfg, iter_caps)


def estimate_batch_budgeted(windows: EventWindow, omega0s: torch.Tensor,
                            iter_caps: torch.Tensor, cfg: CmaxConfig
                            ) -> WindowResult:
    """Batched `estimate_window_budgeted`: `iter_caps` is (B, n_stages)
    int. Per-slot results depend only on that slot's inputs."""
    return _estimate_batch_lockstep(windows, omega0s, cfg,
                                    iter_caps=iter_caps)


def estimate_sequence(windows: EventWindow, omega_init: torch.Tensor,
                      cfg: CmaxConfig) -> Tuple[torch.Tensor, WindowResult]:
    """Sequential estimation over (K, N) windows with warm starts.
    Returns (omegas (K,3), stacked WindowResult traces)."""
    omega = omega_init
    results = []
    for k in range(windows.x.shape[0]):
        res = estimate_window(windows.map(lambda a: a[k]), omega, cfg)
        omega = res.omega
        results.append(res)
    results = stack_results(results)
    return results.omega, results


def estimate_windows_parallel(windows: EventWindow, omega0s: torch.Tensor,
                              cfg: CmaxConfig) -> WindowResult:
    """Batched estimation of independent (B, N) windows (no warm-start
    chaining), in masked lockstep for every engine."""
    return _estimate_batch_lockstep(windows, omega0s, cfg)


def estimate_batch(windows: EventWindow, omega0s: torch.Tensor,
                   cfg: CmaxConfig) -> WindowResult:
    """Batched estimation of B independent windows — the serving hot path.

    `windows` arrays have shape (B, N) with padded slots carrying
    valid=False; `omega0s` is (B, 3) of per-window warm starts. A window
    that saturates early contributes masked no-ops until the slowest window
    in the batch finishes; per-window iteration counts survive in the
    returned traces."""
    return estimate_windows_parallel(windows, omega0s, cfg)


def estimate_batch_donated(windows: EventWindow, omega0s: torch.Tensor,
                           cfg: CmaxConfig) -> WindowResult:
    """`estimate_batch` under the reference's name for its donated form.

    PyTorch donates no buffer, so this aliases `estimate_batch`: the same
    computation and the same results, bit for bit, with the warm starts
    left as they were. Donation gains a meaning once static per-class
    input buffers exist (ROADMAP Queue 2 item 1); until then the async
    service's executable is this function where the reference's donates
    its (B, 3) warm-start buffer."""
    return estimate_batch(windows, omega0s, cfg)


def estimate_streams(windows: EventWindow, omega_inits: torch.Tensor,
                     cfg: CmaxConfig) -> Tuple[torch.Tensor, WindowResult]:
    """Warm-start-chained estimation of S independent streams.

    `windows` arrays have shape (S, K, N); `omega_inits` is (S, 3). At each
    of the K window positions the S streams are one lockstep batch, and
    each stream's next warm start is its own estimate. Returns
    (omegas (S, K, 3), traces stacked as (S, K, ...))."""
    omega = omega_inits.to(cfg.dtype)
    results = []
    for k in range(windows.x.shape[1]):
        res = _estimate_batch_lockstep(windows.map(lambda a: a[:, k]),
                                       omega, cfg)
        omega = res.omega
        results.append(res)
    results = stack_results(results, dim=1)
    return results.omega, results


def lockstep_stage_passes(result: WindowResult) -> List[int]:
    """Batched engine passes a lockstep result took at each stage: the
    entry pass plus one per iteration of its slowest window. Axis 0 is the
    batch; any further axes (estimate_streams' window positions) are
    separate lockstep runs."""
    return [int((1 + st.iters.amax(dim=0)).sum()) for st in result.stages]


def lockstep_passes(result: WindowResult) -> int:
    """Batched engine passes a lockstep result took, over all stages."""
    return sum(lockstep_stage_passes(result))


def measured_stage_gains(result: WindowResult) -> np.ndarray:
    """Measured whole-residence variance gain per stage, (B, S) float64:

        (v_final - v_entry) / (|v_entry| + eps)

    Accepts single-window results (scalar traces -> B = 1) and batched
    results ((B,) traces). Runs on harvested host values."""
    cols = []
    for st in result.stages:
        ve = np.atleast_1d(st.v_entry.detach().cpu().numpy()
                           .astype(np.float64))
        vf = np.atleast_1d(st.v_final.detach().cpu().numpy()
                           .astype(np.float64))
        cols.append((vf - ve) / (np.abs(ve) + 1e-12))
    return np.stack(cols, axis=1) if cols else np.zeros((1, 0))
