"""Shared pipelined event warp front-end (paper Algorithm 2; counterpart of
`repro.core.geometry`).

Computes, for every event:
  * the stage-scaled warped coordinate (x', y') under rotation hypothesis w
  * its integer/fractional decomposition (x0, y0), (ax, ay) for bilinear
    voting
  * the Jacobian rows (r_x, r_y) of the flow displacement wrt w — the paper's
    convention is  r = s*dt * d(flow)/dw,  so  d(x')/dw = -r_x  and
    d(y')/dw = -r_y  (the warp subtracts the flow)
  * the stage-local pixel-group index p_act (= y0 * W_s + x0) with an
    in-range validity flag.

Every function takes an optional leading batch axis: events (..., N) with
omega (..., 3). The arithmetic is the reference's op for op, so the
integer decomposition agrees bit for bit with it on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .types import Camera, EventWindow

_INT_LIMIT = float(2 ** 30)   # finite, exactly representable clamp bound


class WarpOut(NamedTuple):
    """Per-event outputs of Algorithm 2 (shapes (..., N) or (..., N, 3))."""

    xw: torch.Tensor       # warped x' (stage-scaled, float)
    yw: torch.Tensor       # warped y'
    x0: torch.Tensor       # floor(x') int32
    y0: torch.Tensor       # floor(y') int32
    ax: torch.Tensor       # subpixel fraction in x
    ay: torch.Tensor       # subpixel fraction in y
    rx: torch.Tensor       # (..., N, 3) Jacobian row: d(x')/dw = -rx
    ry: torch.Tensor       # (..., N, 3) Jacobian row: d(y')/dw = -ry
    p_act: torch.Tensor    # stage-local pixel-group id, -1 if out of range
    in_range: torch.Tensor  # bool: all four bilinear taps land on the grid


def _omega_parts(omega: torch.Tensor):
    """(wx, wy, wz), each shaped to broadcast against (..., N) events."""
    om = omega.unsqueeze(-2)                      # (..., 1, 3)
    return om[..., 0], om[..., 1], om[..., 2]


def floor_to_int(v: torch.Tensor) -> torch.Tensor:
    """floor(v) as int32, with non-finite values mapped to 0 BEFORE the
    cast (a nan -> int cast differs between CPU and CUDA)."""
    fl = torch.floor(v)
    fl = torch.where(torch.isfinite(fl), fl, torch.zeros_like(fl))
    return fl.clamp(-_INT_LIMIT, _INT_LIMIT).to(torch.int32)


def rotational_flow(xn: torch.Tensor, yn: torch.Tensor, omega: torch.Tensor,
                    fx: float, fy: float):
    """Image-plane flow (u, v) of a purely rotating camera at normalized
    coords (xn, yn) — the linearized rotation field of Alg. 2 lines 4-6.
    `omega` is (3,) or (..., 3) against (..., N) coordinates."""
    B = 1.0 + xn * xn
    D = 1.0 + yn * yn
    XY = xn * yn
    wx, wy, wz = _omega_parts(omega)
    u = fx * (XY * wx - B * wy + yn * wz)
    v = fy * (D * wx - XY * wy - xn * wz)
    return u, v


def warp_events(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                scale: float, t_ref=None) -> WarpOut:
    """Algorithm 2, vectorized over the event window (and batch).

    Args:
      ev: event window, (..., N) (padding -> in_range False).
      omega: (..., 3) rotation-rate hypothesis [wx, wy, wz] (rad/s).
      cam: camera intrinsics (native resolution).
      scale: stage scale s; the warped coordinate is s * (x - dt*u).
      t_ref: (...) reference time; defaults to the window start.
    """
    if t_ref is None:
        t_ref = ev.t_ref
    Hs, Ws = cam.grid(scale)

    xn = (ev.x - cam.cx) / cam.fx
    yn = (ev.y - cam.cy) / cam.fy
    dt = ev.t - torch.as_tensor(t_ref, dtype=ev.t.dtype,
                                device=ev.t.device).unsqueeze(-1)

    B = 1.0 + xn * xn
    D = 1.0 + yn * yn
    XY = xn * yn

    wx, wy, wz = _omega_parts(omega)
    u = cam.fx * (XY * wx - B * wy + yn * wz)
    v = cam.fy * (D * wx - XY * wy - xn * wz)

    xw = scale * (ev.x - dt * u)
    yw = scale * (ev.y - dt * v)

    sdt = scale * dt
    # r_x = s*dt*[fx*XY, -fx*B, fx*yn]; r_y = s*dt*[fy*D, -fy*XY, -fy*xn]
    rx = torch.stack([sdt * cam.fx * XY, -sdt * cam.fx * B,
                      sdt * cam.fx * yn], dim=-1)
    ry = torch.stack([sdt * cam.fy * D, -sdt * cam.fy * XY,
                      -sdt * cam.fy * xn], dim=-1)

    x0 = floor_to_int(xw)
    y0 = floor_to_int(yw)
    ax = xw - x0
    ay = yw - y0

    # All 4 bilinear taps must be on-grid: x0 in [0, Ws-2], y0 in [0, Hs-2].
    in_range = ((x0 >= 0) & (x0 <= Ws - 2) & (y0 >= 0) & (y0 <= Hs - 2)
                & torch.isfinite(xw) & torch.isfinite(yw) & ev.valid)
    p_act = torch.where(in_range, y0 * Ws + x0,
                        torch.full_like(x0, -1))

    return WarpOut(xw=xw, yw=yw, x0=x0, y0=y0, ax=ax, ay=ay, rx=rx, ry=ry,
                   p_act=p_act, in_range=in_range)


def warp_points(x: torch.Tensor, y: torch.Tensor, dt: torch.Tensor,
                omega: torch.Tensor, cam: Camera, scale: float = 1.0):
    """Warp bare (x, y) points by dt under omega — used by tests (no
    Jacobians, no grid decomposition)."""
    xn = (x - cam.cx) / cam.fx
    yn = (y - cam.cy) / cam.fy
    u, v = rotational_flow(xn, yn, omega, cam.fx, cam.fy)
    return scale * (x - dt * u), scale * (y - dt * v)
