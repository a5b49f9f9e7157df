"""Carry configurations, windows and results across from the JAX package.

The system has no weights, so what carries across is its configuration and
state. `config_from_reference` reads a JAX `CmaxConfig` by attribute (it
never imports the JAX package); windows come in and results go out as
numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.pipeline import WindowResult, map_result
from .core.types import Camera, CmaxConfig, EventWindow, StageConfig
from .device import DeviceLike, resolve

#: reference engine name -> the port's counterpart
ENGINE_MAP = {"reference": "reference", "pallas": "cuda",
              "pallas_batched": "cuda_batched"}

_CAMERA_FIELDS = ("width", "height", "fx", "fy", "cx", "cy")
_STAGE_FIELDS = ("scale", "tau", "max_iters", "blur_taps", "blur_sigma",
                 "keep_ratio", "step_scale")


def config_from_reference(cfg) -> CmaxConfig:
    """The port's `CmaxConfig` for a reference `CmaxConfig`, read by
    attribute. `pallas` maps to `cuda` and `pallas_batched` to
    `cuda_batched`; `engine_capacity` carries across (the `cuda` engine
    reads it), and the interpret knob has no counterpart."""
    engine = ENGINE_MAP.get(cfg.engine)
    if engine is None:
        raise ValueError(f"reference engine {cfg.engine!r} has no "
                         f"counterpart in the port; expected one of "
                         f"{tuple(ENGINE_MAP)}")
    dtype = getattr(torch, np.dtype(cfg.dtype).name)
    return CmaxConfig(
        camera=Camera(**{f: getattr(cfg.camera, f) for f in _CAMERA_FIELDS}),
        stages=tuple(StageConfig(**{f: getattr(s, f) for f in _STAGE_FIELDS})
                     for s in cfg.stages),
        adaptive=bool(cfg.adaptive),
        fixed_iters=tuple(int(i) for i in cfg.fixed_iters),
        step_size=float(cfg.step_size),
        use_cgpr=bool(cfg.use_cgpr),
        dtype=dtype,
        engine=engine,
        engine_capacity=int(cfg.engine_capacity),
        engine_rb=int(cfg.engine_rb),
    )


def window_from_numpy(x, y, t, p, valid=None,
                      device: DeviceLike = None) -> EventWindow:
    """An `EventWindow` from array-likes of shape (..., N) on `device`
    (default: the card)."""
    dev = resolve(device)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    v = None if valid is None else torch.tensor(np.asarray(valid, bool),
                                                device=dev)
    return EventWindow(x=f(x), y=f(y), t=f(t), p=f(p), valid=v)


def result_to_numpy(result: WindowResult) -> WindowResult:
    """The same `WindowResult` with every leaf as a numpy array."""
    return map_result(lambda a: a.detach().cpu().numpy(), result)
