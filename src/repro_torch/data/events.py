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

The second half is the serving layer's bucketing: length-class policies,
padding and leader-replicated batch fill, and the ragged cuts a streaming
source produces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# Bucketing: variable-length windows for the serving path. Each raw event
# count is padded up to one of a small set of length classes, so the number
# of executable classes a service holds is bounded by the policy, not by the
# workload. Padded slots carry valid=False and contribute nothing downstream
# (the warp marks them out of range, the sort dumps them in the overflow
# bucket, their IWE weights are zero).
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Maps a raw event count to a padded length class.

    ``sizes=()`` selects power-of-two buckets in [min_bucket, max_bucket]
    (geometric classes: worst-case padding < 2x, log2(max/min)+1 classes).
    A non-empty ``sizes`` tuple gives explicit classes; a single entry pads
    everything to one length (one class, maximal padding), the "no
    bucketing" baseline.
    """

    name: str = "pow2"
    sizes: Tuple[int, ...] = ()
    min_bucket: int = 1024
    max_bucket: int = 1 << 20

    def bucket_of(self, n: int) -> int:
        """Smallest length class holding an n-event window."""
        if n <= 0:
            raise ValueError(f"window must have at least 1 event, got {n}")
        if self.sizes:
            for s in sorted(self.sizes):
                if n <= s:
                    return int(s)
            raise ValueError(
                f"window of {n} events exceeds largest bucket "
                f"{max(self.sizes)} of policy {self.name!r}")
        if n > self.max_bucket:
            raise ValueError(
                f"window of {n} events exceeds max_bucket={self.max_bucket}")
        return min(self.max_bucket, max(self.min_bucket, _next_pow2(n)))

    def classes(self, n_min: int, n_max: int) -> Tuple[int, ...]:
        """Every length class a workload in [n_min, n_max] can occupy: the
        executable classes a service must hold warm for that range."""
        if not (1 <= n_min <= n_max):
            raise ValueError(f"need 1 <= n_min <= n_max, got {n_min}, "
                             f"{n_max}")
        lo, hi = self.bucket_of(n_min), self.bucket_of(n_max)
        if self.sizes:
            return tuple(s for s in sorted(self.sizes) if lo <= s <= hi)
        out = []
        c = lo
        while c <= hi:
            out.append(c)
            c *= 2
        return tuple(out)


def pow2_policy(min_bucket: int = 1024,
                max_bucket: int = 1 << 20) -> BucketPolicy:
    return BucketPolicy(name="pow2", min_bucket=min_bucket,
                        max_bucket=max_bucket)


def single_policy(size: int) -> BucketPolicy:
    """Everything pads to one fixed length — the unbucketed baseline."""
    return BucketPolicy(name=f"single{size}", sizes=(int(size),))


def fixed_policy(sizes: Sequence[int]) -> BucketPolicy:
    sz = tuple(sorted(int(s) for s in sizes))
    return BucketPolicy(name="fixed" + "-".join(map(str, sz)), sizes=sz)


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


def fill_batch(wins: Sequence[EventWindow], n_pad: int, batch_b: int
               ) -> Tuple[EventWindow, int]:
    """Admit a partial batch into a full (batch_b, n_pad) batch class, on
    the device of its windows.

    When fewer than `batch_b` windows are admissible the remaining slots
    replicate the batch leader (finite, well-formed data; the caller
    computes and discards their results). Returns (padded batch, n_fill).
    """
    if not wins:
        raise ValueError("fill_batch needs at least one window")
    n_fill = batch_b - len(wins)
    if n_fill < 0:
        raise ValueError(
            f"{len(wins)} windows exceed batch class {batch_b}")
    ev = batch_windows(list(wins) + [wins[0]] * n_fill, n_pad)
    return ev, n_fill


def bucketize(wins: Sequence[EventWindow], policy: BucketPolicy
              ) -> Dict[int, List[int]]:
    """Group window indices by length class: {bucket_n: [indices]}.

    Bucketing is by array length (`ev.n`), the quantity that sets the
    executable class, not by the number of valid events."""
    out: Dict[int, List[int]] = {}
    for i, w in enumerate(wins):
        out.setdefault(policy.bucket_of(w.n), []).append(i)
    return {k: out[k] for k in sorted(out)}


def padding_overhead(wins: Sequence[EventWindow],
                     policy: BucketPolicy) -> float:
    """Fraction of padded event slots the policy adds: pad / (raw + pad)."""
    raw = sum(w.n for w in wins)
    total = sum(policy.bucket_of(w.n) for w in wins)
    return float(total - raw) / float(max(total, 1))


def ragged_from_sequence(windows: EventWindow, lengths: Sequence[int]
                         ) -> List[EventWindow]:
    """Cut a dense (K, N) sequence into variable-length windows.

    Events within a window are time-ordered, so the first L_k slots are a
    causally contiguous prefix: the shape a streaming source produces when
    it closes windows early (by event count, not time)."""
    K = windows.x.shape[0]
    if len(lengths) != K:
        raise ValueError(f"got {len(lengths)} lengths for {K} windows")
    out = []
    for k, L in enumerate(lengths):
        w = window_slice(windows, k)
        L = int(L)
        if not (0 < L <= w.n):
            raise ValueError(f"length {L} out of range (1, {w.n}] at {k}")
        out.append(w.map(lambda a: a[:L]))
    return out


def ragged_lengths(n_windows: int, n_min: int, n_max: int,
                   seed: int = 0) -> np.ndarray:
    """Heavy-tailed window lengths (log-uniform), as DVS bursts are. The
    reference's numpy draw, so both packages cut the same windows."""
    if not (1 <= n_min <= n_max):
        raise ValueError(
            f"need 1 <= n_min <= n_max, got n_min={n_min} n_max={n_max}")
    rng = np.random.default_rng(seed)
    lo, hi = np.log(n_min), np.log(n_max)
    raw = np.exp(rng.uniform(lo, hi, n_windows)).astype(np.int64)
    # int truncation can land one below n_min; enforce the contract
    return np.clip(raw, n_min, n_max)
