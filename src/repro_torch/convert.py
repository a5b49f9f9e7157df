"""Carry configurations, windows, results and LM weights across from the
JAX package.

The CMAX estimator has no weights, so what carries across is its
configuration and state. `config_from_reference` reads a JAX `CmaxConfig`
by attribute (it never imports the JAX package); windows come in and
results go out as numpy arrays. `lm_params_from_reference` builds the
port's LM from the reference's parameter tree, passed in as numpy arrays,
and `opt_state_from_reference` its optimizer state; both go through
`models.leaves`, the map the optimizer's per-leaf reductions use.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

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


# ---------------------------------------------------------------------------
# LM weights
# ---------------------------------------------------------------------------


def _leaves(tree, prefix: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(dotted path, array) of every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, np.asarray(tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: reinterpret
        return torch.from_numpy(np.array(a).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _reference_flat(tree) -> Dict[str, np.ndarray]:
    return dict(_leaves(tree, ""))


def _check_leaves(groups, flat, what: str) -> None:
    missing = sorted(set(groups) - set(flat))
    extra = sorted(set(flat) - set(groups))
    if missing or extra:
        raise ValueError(f"{what} trees differ: the port lacks {extra}, "
                         f"the reference lacks {missing}")


def lm_params_from_reference(params_np, cfg, max_len: int = 0,
                             device: DeviceLike = None):
    """The port's `Transformer` holding the reference's parameters.

    `params_np` is the reference's parameter tree (`init_params` of
    `repro.models.transformer`) with numpy leaves, e.g.
    `jax.tree.map(np.asarray, params)`. Each port parameter takes its
    reference leaf by `models.leaves.reference_leaf`: the "scan" periods
    (each leaf stacked over the repeats) unstack into layers in depth order
    after the "prefix" layers, then the "suffix" layers follow; the
    reference's (d, H, hd) / (H, hd, d) projections become the port's
    (d, H*hd) / (H*hd, d) matrices by a row-major reshape. Every parameter
    of the port must be covered. `max_len` sizes the learned positions (the
    reference's table sets it when 0). The model is built on the CPU and
    moved to `device` (default: the card)."""
    from .models import transformer as tfm
    from .models.leaves import leaf_groups, reference_leaf

    flat = _reference_flat(params_np)
    if cfg.pos_embedding == "learned" and not max_len:
        max_len = flat["pos.pos"].shape[0]

    model = tfm.Transformer(cfg, torch.Generator().manual_seed(0), max_len)
    own = model.state_dict()
    _check_leaves(leaf_groups(cfg, {n: t.shape for n, t in own.items()}),
                  flat, "parameter")
    state = {}
    for name, t in own.items():
        key, idx = reference_leaf(name, cfg)
        a = flat[key] if idx is None else flat[key][idx]
        if a.size != t.numel():
            raise ValueError(f"{name}: reference shape {a.shape} does not "
                             f"fit the port's {tuple(t.shape)}")
        state[name] = _tensor(a).reshape(t.shape).to(t.dtype)
    model.load_state_dict(state)
    return model.to(resolve(device))


def opt_state_from_reference(state_np, cfg, optimizer: str = "adamw",
                             device: DeviceLike = None):
    """The port's optimizer state (`train.optim.AdamWState` or
    `AdafactorState`) holding the reference's.

    `state_np` is the reference's state (`adamw_init` / `adafactor_init` of
    `repro.train.optim`, or a state an update returned) with numpy leaves.
    The port keeps optimizer state by reference leaf, in the reference's
    layout (`models.leaves`), so each moment carries across as it is: the
    AdamW moments `mu`, `nu` and the Adafactor moments `vr`, `vc` keyed by
    the leaf's dotted path, and `step` as an int. Every leaf of the port's
    model must be covered, at the reference's shape."""
    from .models import transformer as tfm
    from .train import optim

    field = lambda k: state_np[k] if isinstance(state_np, dict) \
        else getattr(state_np, k)
    if optimizer == "adamw":
        cls, init, ocfg = optim.AdamWState, optim.adamw_init, \
            optim.AdamWConfig()
    elif optimizer == "adafactor":
        cls, init, ocfg = optim.AdafactorState, optim.adafactor_init, \
            optim.AdafactorConfig()
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    moments = {k: _reference_flat(field(k)) for k in cls._fields[1:]}
    max_len = 0
    if cfg.pos_embedding == "learned":
        max_len = moments[cls._fields[1]]["pos.pos"].shape[0]
    want = init(ocfg, tfm.Transformer(cfg, None, max_len))  # meta shapes
    dev = resolve(device)
    out = {}
    for k, flat in moments.items():
        shapes = getattr(want, k)
        _check_leaves(shapes, flat, f"optimizer state {k!r}")
        for key, a in flat.items():
            if tuple(a.shape) != tuple(shapes[key].shape):
                raise ValueError(f"{k} {key}: reference shape {a.shape}, "
                                 f"the port's leaf is "
                                 f"{tuple(shapes[key].shape)}")
        out[k] = {key: _tensor(flat[key]).to(dev) for key in shapes}
    return cls(step=int(np.asarray(field("step"))), **out)
