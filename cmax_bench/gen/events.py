"""Synthetic DVS recordings, drawn from a seed.

A frozen, vectorised copy of the law of the port's
`data/events.py::make_sequence` (and of the reference package's): a
textured poster scene of point features with polarity, a smooth rotation
(a sum of sinusoids per axis) with occasional velocity jerks, events along
each feature's image-plane trajectory within a window at a rate
proportional to the local flow, integer DVS pixels with noise, and an IMU
reading = the true rate + IMU-grade noise. Every window of a recording is
drawn at once on `device` with one `torch.Generator`, so a recording of
thousands of windows takes a few calls, not a loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Sensor:
    """Pinhole intrinsics of the DVS sensor (DAVIS240C by default)."""

    width: int = 240
    height: int = 180
    fx: float = 199.0
    fy: float = 199.0
    cx: float = 120.0
    cy: float = 90.0


@dataclasses.dataclass(frozen=True)
class Scene:
    """The scene and motion law of a recording."""

    n_features: int = 2500
    noise_px: float = 0.35
    omega_scale: float = 3.5      # rad/s peak per axis
    window_dt: float = 0.02       # seconds a window spans
    imu_noise: float = 0.03       # rad/s
    jerk_prob: float = 0.2        # P(velocity step at a window boundary)
    jerk_scale: float = 0.5       # jerk size as a fraction of omega_scale


class Recording(NamedTuple):
    """K windows of N events each, and the rates behind them."""

    x: torch.Tensor           # (K, N) f32 integer pixel column
    y: torch.Tensor           # (K, N) f32 integer pixel row
    t: torch.Tensor           # (K, N) f32 seconds, ascending in a window
    p: torch.Tensor           # (K, N) f32 polarity +-1
    valid: torch.Tensor       # (K, N) bool: the event lies on the sensor
    omega_true: torch.Tensor  # (K, 3) f32 rad/s
    omega_imu: torch.Tensor   # (K, 3) f32 rad/s


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream of a run: any whole number is a seed
    (negative or beyond 64 bits too), and streams draw apart."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream) * 7_919 + 17)
                  % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float64)


def omega_trajectory(scene: Scene, n_windows: int, g: torch.Generator,
                     device) -> torch.Tensor:
    """Per-window constant rotation rate, (K, 3) float64: per axis the mean
    of three sinusoids, plus velocity steps that persist."""
    t = (torch.arange(n_windows, device=device, dtype=torch.float64)
         + 0.5) * scene.window_dt
    amps = _uniform(g, (3, 3), 0.3, 1.0, device) * scene.omega_scale
    freqs = _uniform(g, (3, 3), 0.1, 0.9, device)
    phases = _uniform(g, (3, 3), 0.0, 2 * math.pi, device)
    # (K, axis, term)
    out = (amps * torch.sin(2 * math.pi * freqs * t[:, None, None]
                            + phases)).sum(-1) / 3.0
    jump = torch.rand(n_windows, generator=g, device=device,
                      dtype=torch.float64) < scene.jerk_prob
    jump[0] = False
    steps = torch.randn((n_windows, 3), generator=g, device=device,
                        dtype=torch.float64) \
        * (scene.jerk_scale * scene.omega_scale)
    return out + torch.cumsum(steps * jump[:, None], dim=0)


def flow(x, y, omega, sensor: Sensor):
    """Image-plane flow (u, v) of a rotating camera at pixel (x, y);
    `omega` broadcasts as (..., 1) per axis."""
    xn = (x - sensor.cx) / sensor.fx
    yn = (y - sensor.cy) / sensor.fy
    b = 1.0 + xn * xn
    d = 1.0 + yn * yn
    xy = xn * yn
    u = sensor.fx * (xy * omega[..., 0:1] - b * omega[..., 1:2]
                     + yn * omega[..., 2:3])
    v = sensor.fy * (d * omega[..., 0:1] - xy * omega[..., 1:2]
                     - xn * omega[..., 2:3])
    return u, v


def record(sensor: Sensor, scene: Scene, n_windows: int, n_events: int,
           g: torch.Generator, device) -> Recording:
    """One recording of `n_windows` windows of `n_events` events. Events
    of window k span [k dt, (k + 1) dt), in time order; warping them back
    to the window's start with omega_true[k] collapses each feature."""
    K, N, M = n_windows, n_events, scene.n_features
    omega = omega_trajectory(scene, K, g, device)
    imu = omega + torch.randn((K, 3), generator=g, device=device,
                              dtype=torch.float64) * scene.imu_noise
    margin = 18.0    # features away from the borders keep warps in frame
    fx = _uniform(g, (K, M), margin, sensor.width - margin, device)
    fy = _uniform(g, (K, M), margin, sensor.height - margin, device)
    fp = torch.where(torch.rand((K, M), generator=g, device=device) < 0.5,
                     -1.0, 1.0)
    u, v = flow(fx, fy, omega, sensor)
    # event rate proportional to the local flow: features drawn by the
    # inverse of their cumulative rate
    rate = torch.sqrt(u * u + v * v) + 5.0
    cdf = torch.cumsum(rate, dim=1)
    cdf = cdf / cdf[:, -1:]
    draw = torch.rand((K, N), generator=g, device=device,
                      dtype=torch.float64)
    fid = torch.searchsorted(cdf, draw, right=True).clamp_(max=M - 1)
    dt = torch.sort(_uniform(g, (K, N), 0.0, scene.window_dt, device),
                    dim=1).values
    pick = lambda a: torch.gather(a, 1, fid)
    ex = pick(fx) + dt * pick(u) + scene.noise_px * torch.randn(
        (K, N), generator=g, device=device, dtype=torch.float64)
    ey = pick(fy) + dt * pick(v) + scene.noise_px * torch.randn(
        (K, N), generator=g, device=device, dtype=torch.float64)
    ex, ey = torch.round(ex), torch.round(ey)
    valid = (ex >= 0) & (ex < sensor.width) & (ey >= 0) \
        & (ey < sensor.height)
    t0 = torch.arange(K, device=device, dtype=torch.float64)[:, None] \
        * scene.window_dt
    f32 = lambda a: a.to(torch.float32)
    return Recording(f32(ex), f32(ey), f32(t0 + dt), f32(pick(fp)), valid,
                     f32(omega), f32(imu))
