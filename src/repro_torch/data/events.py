"""Synthetic DVS event-stream generator with ground-truth rotation
(counterpart of `repro.data.events`).

The generator is the reference's numpy code, kept here as its own copy: the
same `SequenceSpec` and seed give bit-identical windows in both packages.

  * a textured scene = M point features with polarity,
  * a smooth rotational trajectory omega_true(t) (sum of sinusoids, scaled
    to DAVIS-like magnitudes of a few rad/s),
  * events along each feature's image-plane trajectory within a window,
    with pixel quantization + noise — warping with the true omega collapses
    each feature's events back onto a point,
  * an "IMU" reference = omega_true + IMU-grade noise.

Two named presets mirror the paper's sequences: `POSTER` and `BOXES`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.types import Camera, EventWindow
from ..device import DeviceLike, resolve


@dataclasses.dataclass(frozen=True)
class SequenceSpec:
    name: str = "poster"
    n_windows: int = 24
    events_per_window: int = 8192
    n_features: int = 160
    noise_px: float = 0.35
    omega_scale: float = 3.0          # rad/s peak per axis
    window_dt: float = 0.02           # 20 ms windows
    imu_noise: float = 0.03           # rad/s IMU reference noise
    jerk_prob: float = 0.2            # P(velocity step at a window boundary)
    jerk_scale: float = 0.5           # jerk magnitude as fraction of scale
    seed: int = 0
    camera: Camera = Camera()


POSTER = SequenceSpec(name="poster", n_features=220, events_per_window=8192,
                      omega_scale=3.5, seed=11)
BOXES = SequenceSpec(name="boxes", n_features=90, events_per_window=8192,
                     omega_scale=2.5, noise_px=0.5, seed=23)


def _omega_trajectory(spec: SequenceSpec, rng: np.random.Generator
                      ) -> np.ndarray:
    """Per-window constant omega_true: smooth sum-of-sinusoids, (K,3)."""
    t = (np.arange(spec.n_windows) + 0.5) * spec.window_dt
    out = np.zeros((spec.n_windows, 3))
    for j in range(3):
        amps = rng.uniform(0.3, 1.0, size=3) * spec.omega_scale
        freqs = rng.uniform(0.1, 0.9, size=3)
        phases = rng.uniform(0, 2 * np.pi, size=3)
        out[:, j] = sum(a * np.sin(2 * np.pi * f * t + ph)
                        for a, f, ph in zip(amps, freqs, phases)) / 3.0
    # occasional velocity steps make window difficulty heterogeneous
    for k in range(1, spec.n_windows):
        if rng.random() < spec.jerk_prob:
            out[k:] += rng.normal(0, spec.jerk_scale * spec.omega_scale,
                                  size=3)
    return out


def _flow(x, y, omega, cam: Camera):
    xn = (x - cam.cx) / cam.fx
    yn = (y - cam.cy) / cam.fy
    B = 1.0 + xn * xn
    D = 1.0 + yn * yn
    XY = xn * yn
    u = cam.fx * (XY * omega[0] - B * omega[1] + yn * omega[2])
    v = cam.fy * (D * omega[0] - XY * omega[1] - xn * omega[2])
    return u, v


def make_sequence(spec: SequenceSpec, device: DeviceLike = None
                  ) -> Tuple[EventWindow, torch.Tensor, torch.Tensor]:
    """Returns (windows (K,N) EventWindow, omega_true (K,3),
    omega_imu (K,3)) on `device` (default: the card).

    Events of window k span [t0_k, t0_k + window_dt]; warping back to t0_k
    with omega_true[k] re-collapses each feature."""
    dev = resolve(device)
    rng = np.random.default_rng(spec.seed)
    cam = spec.camera
    K, N, M = spec.n_windows, spec.events_per_window, spec.n_features

    omega_true = _omega_trajectory(spec, rng)
    omega_imu = omega_true + rng.normal(0, spec.imu_noise, omega_true.shape)

    xs = np.zeros((K, N), np.float32)
    ys = np.zeros((K, N), np.float32)
    ts = np.zeros((K, N), np.float32)
    ps = np.zeros((K, N), np.float32)
    valid = np.zeros((K, N), bool)

    margin = 18.0  # keep features away from borders so warps stay in frame
    for k in range(K):
        t0 = k * spec.window_dt
        fx = rng.uniform(margin, cam.width - margin, size=M)
        fy = rng.uniform(margin, cam.height - margin, size=M)
        fp = rng.choice([-1.0, 1.0], size=M)
        # event rate proportional to local flow magnitude
        u, v = _flow(fx, fy, omega_true[k], cam)
        rate = np.sqrt(u * u + v * v) + 5.0
        prob = rate / rate.sum()
        fid = rng.choice(M, size=N, p=prob)
        dt = rng.uniform(0.0, spec.window_dt, size=N)
        order = np.argsort(dt)
        fid, dt = fid[order], dt[order]
        ex = fx[fid] + dt * u[fid] + rng.normal(0, spec.noise_px, N)
        ey = fy[fid] + dt * v[fid] + rng.normal(0, spec.noise_px, N)
        # DVS pixels are integers
        ex = np.round(ex)
        ey = np.round(ey)
        ok = (ex >= 0) & (ex < cam.width) & (ey >= 0) & (ey < cam.height)
        xs[k], ys[k] = ex, ey
        ts[k] = t0 + dt
        ps[k] = fp[fid]
        valid[k] = ok

    t = lambda a: torch.as_tensor(a, device=dev)
    return (EventWindow(t(xs), t(ys), t(ts), t(ps), t(valid)),
            t(omega_true.astype(np.float32)),
            t(omega_imu.astype(np.float32)))


def window_slice(windows: EventWindow, k: int) -> EventWindow:
    return windows.map(lambda a: a[k])


def pad_window(ev: EventWindow, n_pad: int) -> EventWindow:
    """Pad a single (N,) window to (n_pad,) with valid=False slots (zeros
    elsewhere; padding is never read)."""
    n = ev.n
    if n > n_pad:
        raise ValueError(f"cannot pad window of {n} events to {n_pad}")
    if n == n_pad:
        return ev
    pad = lambda a: torch.nn.functional.pad(a, (0, n_pad - n))
    return EventWindow(x=pad(ev.x), y=pad(ev.y), t=pad(ev.t), p=pad(ev.p),
                       valid=pad(ev.valid))


def batch_windows(wins: Sequence[EventWindow],
                  n_pad: int = None) -> EventWindow:
    """Stack variable-length windows into one (B, n_pad) padded batch."""
    if not wins:
        raise ValueError("batch_windows needs at least one window")
    if n_pad is None:
        n_pad = max(w.n for w in wins)
    padded = [pad_window(w, n_pad) for w in wins]
    stack = lambda f: torch.stack([f(w) for w in padded])
    return EventWindow(x=stack(lambda w: w.x), y=stack(lambda w: w.y),
                       t=stack(lambda w: w.t), p=stack(lambda w: w.p),
                       valid=stack(lambda w: w.valid))
