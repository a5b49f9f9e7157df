"""Architecture registry (counterpart of `repro.configs`): one module per
assigned architecture (exact published config + reduced smoke config),
plus the paper's own CMAX pipeline config (configs/cmax_camel.py)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "llama_3_2_vision_11b",
    "whisper_tiny",
    "deepseek_moe_16b",
    "kimi_k2_1t_a32b",
    "deepseek_67b",
    "chatglm3_6b",
    "llama3_2_1b",
    "codeqwen1_5_7b",
    "xlstm_1_3b",
    "recurrentgemma_9b",
]

# CLI-friendly aliases (--arch with dashes, as in the assignment sheet)
ALIASES: Dict[str, str] = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-tiny": "whisper_tiny",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-67b": "deepseek_67b",
    "chatglm3-6b": "chatglm3_6b",
    "llama3.2-1b": "llama3_2_1b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
