"""The LM-family models (counterpart of `repro.models`): the config, the
layers, MoE, the recurrent cells, the assembled transformer and the
serving-side step factories."""
from .config import ModelConfig
from .model import (SHAPES, ShapeSpec, loss_fn, make_eval_step,
                    make_prefill_step, make_serve_step, shape_applicable)
from . import layers, moe, recurrent, transformer

__all__ = [
    "ModelConfig", "SHAPES", "ShapeSpec", "loss_fn", "make_eval_step",
    "make_prefill_step", "make_serve_step", "shape_applicable", "layers",
    "moe", "recurrent", "transformer",
]
