"""Plain PyTorch reference of CMAX-CAMEL's estimator: a frozen copy of the
algorithm, written apart from the port and importing nothing of it.

For every stage s of the coarse-to-fine schedule (s = 1/4, 1/2, 1):

  1. Alg. 3: warp the window under the stage's entry rate, group events by
     their pixel on the stage grid, keep every round(1/rho_s)-th event of
     each group in time order (rho_s = s);
  2. the entry engine pass;
  3. Alg. 1's residence loop: a CG-PR proposal (PR+ beta, a normalised step
     alpha), one engine pass, accept when the variance rises (else revert
     and halve alpha), stop when an accepted step gains less than tau_s
     relatively, when alpha falls under alpha0 / 64, or after max_iters.

One engine pass: warp every retained event by omega (the linearised
rotation field of Alg. 2), vote it bilinearly into the image of warped
events (IWE) and its three derivative images, blur the four images with
the stage's separable Gaussian (zero 'same' padding), and reduce them to
the eight sums of Eq. 12, which give the variance and its gradient.

Windows are estimated together, each in its own row: the rows share no
arithmetic, so a window's answer does not depend on the rows beside it.
The engine pass's votes, images, blur and sums run in `dtype` (float32,
as the configurations state; the benchmark's control runs them in
bfloat16). The warp, the rate, the optimiser and Eq. 12's final
arithmetic run in the precision of the events given: float32, or float64
for the witness that measures how far float32 chains drift
(`witness.py`). Votes are summed
with PyTorch's deterministic scatter, so the reference gives the same bits
on every run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Stage:
    scale: float
    tau: float
    max_iters: int
    blur_taps: int
    blur_sigma: float
    keep_ratio: float
    step_scale: float


@dataclasses.dataclass(frozen=True)
class Schedule:
    """What the reference needs of a configuration file."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    stages: Tuple[Stage, ...]
    step_size: float

    def grid(self, scale: float) -> Tuple[int, int]:
        return (int(math.ceil(scale * self.height)),
                int(math.ceil(scale * self.width)))

    @classmethod
    def from_config(cls, cfg: dict) -> "Schedule":
        sched = cfg["schedule"]
        if not sched.get("adaptive", True):
            raise ValueError("the reference runs the adaptive schedule only")
        return cls(**cfg["sensor"], step_size=sched["step_size"],
                   stages=tuple(Stage(**st) for st in sched["stages"]))


@contextlib.contextmanager
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def gaussian(k: int, sigma: float, dtype, device) -> torch.Tensor:
    half = k // 2
    xs = torch.arange(-half, half + 1, dtype=torch.promote_types(F32, dtype),
                      device=device)
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    return (g / g.sum()).to(dtype)


def warp(x, y, dt, omega, sc: Schedule, scale: float):
    """Warped, stage-scaled coordinates (xw, yw) of every event and the
    rows r_x, r_y (..., N, 3) with d(xw)/d omega = -r_x, d(yw)/d omega =
    -r_y. Events are (B, N); omega is (B, 3)."""
    xn = (x - sc.cx) / sc.fx
    yn = (y - sc.cy) / sc.fy
    b = 1.0 + xn * xn
    d = 1.0 + yn * yn
    xy = xn * yn
    wx, wy, wz = (omega[:, i:i + 1] for i in range(3))
    u = sc.fx * (xy * wx - b * wy + yn * wz)
    v = sc.fy * (d * wx - xy * wy - xn * wz)
    xw = scale * (x - dt * u)
    yw = scale * (y - dt * v)
    sdt = scale * dt
    rx = torch.stack([sdt * sc.fx * xy, -sdt * sc.fx * b, sdt * sc.fx * yn],
                     dim=-1)
    ry = torch.stack([sdt * sc.fy * d, -sdt * sc.fy * xy, -sdt * sc.fy * xn],
                     dim=-1)
    return xw, yw, rx, ry


def _cell(xw, yw, valid, hs: int, ws: int):
    """Top-left pixel (x0, y0) of each event's bilinear footprint and
    whether all four taps land on the (hs, ws) grid."""
    fin = torch.isfinite(xw) & torch.isfinite(yw)
    x0 = torch.floor(torch.where(fin, xw, torch.zeros_like(xw)))
    y0 = torch.floor(torch.where(fin, yw, torch.zeros_like(yw)))
    on = (fin & valid & (x0 >= 0) & (x0 <= ws - 2) & (y0 >= 0)
          & (y0 <= hs - 2))
    return x0, y0, on


def retained(ev, omega, sc: Schedule, stage: Stage) -> torch.Tensor:
    """Alg. 3: the (B, N) float32 weight of each event, 1 where it is
    kept. Events are grouped by pixel under the entry warp; within a group,
    in time order, every stride-th event is kept, from the first."""
    x, y, dt, _, valid = ev
    hs, ws = sc.grid(stage.scale)
    xw, yw, _, _ = warp(x, y, dt, omega, sc, stage.scale)
    x0, y0, on = _cell(xw, yw, valid, hs, ws)
    big = hs * ws
    key = torch.where(on, y0 * ws + x0,
                      torch.full_like(x0, big)).to(torch.int64)
    order = torch.sort(key, dim=1, stable=True).indices
    ks = torch.gather(key, 1, order)
    n = ks.shape[1]
    pos = torch.arange(n, device=ks.device).expand_as(ks)
    new_run = torch.ones_like(ks, dtype=torch.bool)
    new_run[:, 1:] = ks[:, 1:] != ks[:, :-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=1).values
    rank = pos - run_start
    stride = max(1, int(round(1.0 / max(stage.keep_ratio, 1e-6))))
    keep_sorted = (ks < big) & (rank % stride == 0)
    keep = torch.zeros_like(keep_sorted)
    keep.scatter_(1, order, keep_sorted)
    return keep.to(x.dtype)


def _fir_lastdim(img, taps):
    k = taps.shape[0]
    half = k // 2
    n = img.shape[-1]
    pad = torch.nn.functional.pad(img, (half, half))
    out = torch.zeros_like(img)
    for i in range(k):
        out = out + taps[i] * pad[..., i:i + n]
    return out


def engine_pass(ev, weights, omega, sc: Schedule, stage: Stage,
                dtype=F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(variance (B,), gradient (B, 3)) of the blurred IWE at `omega`."""
    x, y, dt, p, valid = ev
    hs, ws = sc.grid(stage.scale)
    npix = hs * ws
    # the warp stays in float32 whatever `dtype` is: a coarser coordinate
    # would put every vote on a whole pixel
    xw, yw, rx, ry = warp(x, y, dt, omega.to(x.dtype), sc, stage.scale)
    x0, y0, on = _cell(xw, yw, valid, hs, ws)
    c = lambda a: a.to(dtype)
    ax, ay, rx, ry = c(xw - x0), c(yw - y0), c(rx), c(ry)
    pe = torch.where(on, c(p * weights), torch.zeros_like(ax))
    # taps (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1)
    w = torch.stack([(1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay,
                     ax * ay], dim=-1)                           # (B, N, 4)
    cx = torch.stack([1 - ay, -(1 - ay), ay, -ay], dim=-1)
    cy = torch.stack([1 - ax, ax, -(1 - ax), -ax], dim=-1)
    dw = cx[..., None] * rx[..., None, :] + cy[..., None] * ry[..., None, :]
    vals = pe[..., None, None] * torch.cat([w[..., None], dw], dim=-1)
    B, N = x.shape
    xi = torch.where(on, x0, 0).to(torch.int64)
    yi = torch.where(on, y0, 0).to(torch.int64)
    rows = torch.arange(B, device=x.device)[:, None, None] * npix
    idx = torch.stack([yi * ws + xi, yi * ws + xi + 1, (yi + 1) * ws + xi,
                       (yi + 1) * ws + xi + 1], dim=-1) + rows   # (B, N, 4)
    img = torch.zeros((B * npix, 4), dtype=dtype, device=x.device)
    with _deterministic():
        img.index_add_(0, idx.reshape(-1), vals.reshape(-1, 4))
    img = img.reshape(B, hs, ws, 4).permute(0, 3, 1, 2)          # (B,4,H,W)
    taps = gaussian(stage.blur_taps, stage.blur_sigma, dtype, x.device)
    blur = _fir_lastdim(_fir_lastdim(img, taps).transpose(-1, -2),
                        taps).transpose(-1, -2)
    i_img, d_img = blur[:, 0], blur[:, 1:]
    f = lambda a: a.sum(dim=(-2, -1)).to(x.dtype)
    s1, s2 = f(i_img), f(i_img * i_img)
    g, t = f(i_img[:, None] * d_img), f(d_img)
    var = s2 / npix - (s1 / npix) ** 2
    grad = (2.0 / npix) * (g - s1[:, None] * t / npix)
    return var, grad


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cg_step(omega, g, g_prev, d_prev, first, alpha):
    """PR+ conjugate direction (steepest ascent when there is no history
    or the direction does not ascend) and a step of length alpha."""
    denom = torch.clamp(_dot(g_prev, g_prev), min=1e-24)
    beta = torch.clamp(_dot(g, g - g_prev) / denom, min=0.0)
    beta = torch.where(first, torch.zeros_like(beta), beta)
    d = g + beta[:, None] * d_prev
    d = torch.where((_dot(d, g) > 0.0)[:, None], d, g)
    norm = torch.sqrt(_dot(d, d))
    return omega + alpha[:, None] * d / (norm + 1e-12)[:, None], d


def estimate(ev, omega0, sc: Schedule, dtype=F32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate B windows at once from their warm starts.

    `ev` is (x, y, dt, p, valid), each (B, N) on one device, dt the time
    since the window's first event; `omega0` is (B, 3). Returns (omega
    (B, 3) in the events' precision, iterations (B, n_stages) int64)."""
    omega = omega0.to(ev[0].dtype)
    B = omega.shape[0]
    dev = omega.device
    iters: List[torch.Tensor] = []
    for stage in sc.stages:
        weights = retained(ev, omega, sc, stage)
        v_prev, g = engine_pass(ev, weights, omega, sc, stage, dtype)
        alpha = torch.full((B,), sc.step_size * stage.step_scale,
                           dtype=omega.dtype, device=dev)
        floor = alpha / 64.0
        g_prev = torch.zeros((B, 3), dtype=omega.dtype, device=dev)
        d_prev = torch.zeros_like(g_prev)
        first = torch.ones((B,), dtype=torch.bool, device=dev)
        it = torch.zeros((B,), dtype=torch.int64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for _ in range(stage.max_iters):
            live = ~done
            if not bool(live.any()):
                break
            om_p, d = _cg_step(omega, g, g_prev, d_prev, first, alpha)
            v_p, g_p = engine_pass(ev, weights, om_p, sc, stage, dtype)
            up = live & (v_p > v_prev)
            gain = (v_p - v_prev) / torch.clamp(v_prev.abs(), min=1e-12)
            alpha_n = torch.where(up, alpha, alpha * 0.5)
            stop = (up & (gain < stage.tau)) \
                | (live & ~up & (alpha_n < floor))
            sel = lambda a, b: torch.where(up[:, None], a, b)
            omega = sel(om_p, omega)
            g_prev, d_prev = sel(g, g_prev), sel(d, d_prev)
            g = sel(g_p, g)
            first = first & ~up
            v_prev = torch.where(up, v_p, v_prev)
            alpha = torch.where(live, alpha_n, alpha)
            it = it + live.to(torch.int64)
            done = done | stop
        iters.append(it)
    return omega, torch.stack(iters, dim=1)
