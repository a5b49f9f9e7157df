"""Step factories and the assigned input shapes (counterpart of
`repro.models.model`, serving half): the shape cells, the loss, and the
eval / prefill / serve steps over a `transformer.Transformer`.

Each factory takes the config the step is for and returns a step over a
model of that config; a model of another config is refused. The training
step, the abstract input specs and the abstract parameter and optimizer
trees belong to the training and dry-run slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from . import transformer as tfm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic decode state; decode shapes need a
    decoder (all assigned archs have one)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k-context decode "
                       "skipped per brief (no sub-quadratic attention)")
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean cross entropy with z-loss, computed in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = lse - true
    return ce.mean() + z_loss * (lse ** 2).mean()


def _check(model: tfm.Transformer, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name!r} got a model of "
                         f"{model.cfg.name!r} (or another variant)")


def make_eval_step(cfg: ModelConfig) -> Callable:
    """step(model, batch) -> {"loss", "logits_mean"}; batch: dict(tokens,
    labels [, cross_source])."""
    def step(model, batch):
        _check(model, cfg)
        logits = tfm.forward(model, batch["tokens"],
                             cross_source=batch.get("cross_source"))
        return {"loss": loss_fn(logits, batch["labels"]),
                "logits_mean": logits.mean()}
    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Prefill: full forward returning last-position logits (B, V)."""
    def step(model, batch):
        _check(model, cfg)
        logits = tfm.forward(model, batch["tokens"],
                             cross_source=batch.get("cross_source"))
        return logits[:, -1]
    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """Decode: one new token against a populated cache.
    step(model, cache, token, cross_source=None) -> (next token (B, 1)
    int32, logits (B, 1, V) float32, cache)."""
    def step(model, cache, token, cross_source=None):
        _check(model, cfg)
        logits, cache = tfm.decode_step(model, token, cache,
                                        cross_source=cross_source)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache
    return step
