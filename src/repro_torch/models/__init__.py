"""The LM-family models (counterpart of `repro.models`): the config, the
layers, MoE, the recurrent cells, the assembled transformer and the
step factories, with the leaf map onto the reference's parameter tree."""
from .config import ModelConfig
from .model import (SHAPES, ShapeSpec, abstract_opt_state, abstract_params,
                    input_specs, loss_and_grads, loss_fn, make_eval_step,
                    make_prefill_step, make_serve_step, make_train_step,
                    shape_applicable)
from . import layers, leaves, moe, recurrent, transformer

__all__ = [
    "ModelConfig", "SHAPES", "ShapeSpec", "abstract_opt_state",
    "abstract_params", "input_specs", "loss_and_grads", "loss_fn",
    "make_eval_step", "make_prefill_step", "make_serve_step",
    "make_train_step", "shape_applicable", "layers", "leaves", "moe",
    "recurrent", "transformer",
]
