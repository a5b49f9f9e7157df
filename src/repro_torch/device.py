"""Device selection shared by every tensor-creating helper of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device a new tensor goes to: CUDA unless the caller names one.

    Asking for CUDA (explicitly or by default) without a card raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
