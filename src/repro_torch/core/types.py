"""Core datatypes for the CMAX-CAMEL pipeline (counterpart of
`repro.core.types`).

Configuration is frozen dataclasses of static metadata; an event window is
a small dataclass of tensors that may carry a leading batch axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera intrinsics for a DVS sensor (DAVIS240C by default)."""

    width: int = 240
    height: int = 180
    fx: float = 199.0
    fy: float = 199.0
    cx: float = 120.0
    cy: float = 90.0

    def grid(self, s: float) -> Tuple[int, int]:
        """(H_s, W_s) = (ceil(s*H), ceil(s*W)) per the paper. Intrinsics are
        not scaled: warped coordinates are scaled by s after warping."""
        return (int(math.ceil(s * self.height)),
                int(math.ceil(s * self.width)))


@dataclasses.dataclass
class EventWindow:
    """A window of events: x, y, t, p (+ validity mask), each of shape
    (..., N). A leading batch axis is allowed everywhere; `valid` marks real
    events (padding has valid=False and contributes nothing)."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    valid: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.valid is None:
            self.valid = torch.ones_like(self.x, dtype=torch.bool)

    @property
    def n(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def t_ref(self) -> torch.Tensor:
        """Reference time = first valid timestamp (min over valid); +inf
        for a window without valid events."""
        big = torch.where(self.valid, self.t,
                          torch.full_like(self.t, math.inf))
        return big.amin(dim=-1)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "EventWindow":
        """Apply `fn` to every field (indexing, device moves, stacking)."""
        return EventWindow(fn(self.x), fn(self.y), fn(self.t), fn(self.p),
                           fn(self.valid))

    def __repr__(self):
        return f"EventWindow(shape={tuple(self.x.shape)})"


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One coarse-to-fine stage (paper §2-3)."""

    scale: float            # s in {1/4, 1/2, 1}
    tau: float              # variance-gain threshold tau_s (Alg. 1)
    max_iters: int          # hard cap on stage residence (HW watchdog)
    blur_taps: int          # 3 / 5 / 9 per paper §4
    blur_sigma: float       # Gaussian sigma at this stage
    keep_ratio: float       # rho_s = s (paper §2); 1.0 disables subsampling
    step_scale: float = 1.0  # CG-PR step multiplier (coarse stages step big)

    def grid(self, cam: Camera) -> Tuple[int, int]:
        return cam.grid(self.scale)


#: Selectable engine-pass backends (CmaxConfig.engine):
#:   "reference"    — the plain PyTorch scatter + blur_separable datapath
#:                    (the correctness oracle)
#:   "cuda"         — the per-window engine (counterpart of "pallas"): per
#:                    engine pass, the tile-sorting prologue, ONE launch of
#:                    the tile-accumulation kernel over each tile's whole
#:                    run of taps (kernels/iwe_accum.py) and ONE launch of
#:                    the streaming blur-statistics kernel
#:                    (kernels/blur_stats.py), for a window or a batch
#:   "cuda_batched" — the batched engine: per engine pass, the binning
#:                    prologue plus ONE launch of the hand-written CUDA
#:                    kernel for the whole batch (kernels/megakernel.py);
#:                    the residence loop runs windows in masked lockstep.
#: On CPU tensors the kernel engines run their kernels' plain versions.
ENGINES = ("reference", "cuda", "cuda_batched")


@dataclasses.dataclass(frozen=True)
class CmaxConfig:
    """Full pipeline configuration (paper-faithful defaults).

    Unlike the JAX reference, the default engine is "cuda_batched": the
    main path on the card is the kernel. `engine_capacity` is the per-tile
    tap budget the "cuda" engine counts its `spilled` taps against: its
    kernel reads each tile's whole run, so the budget changes neither the
    result nor the speed; the "cuda_batched" kernel reads variable-length
    per-pixel segments and has no capacity. `engine_rb` is that kernel's
    row-slab height (rows of output per block).
    """

    camera: Camera = Camera()
    stages: Tuple[StageConfig, ...] = (
        StageConfig(scale=0.25, tau=1e-3, max_iters=40, blur_taps=3,
                    blur_sigma=0.5, keep_ratio=0.25, step_scale=2.0),
        StageConfig(scale=0.5, tau=4e-4, max_iters=40, blur_taps=5,
                    blur_sigma=0.75, keep_ratio=0.5, step_scale=1.4),
        StageConfig(scale=1.0, tau=1.5e-4, max_iters=40, blur_taps=9,
                    blur_sigma=1.0, keep_ratio=1.0, step_scale=1.0),
    )
    adaptive: bool = True
    fixed_iters: Tuple[int, ...] = (10, 10, 15)   # fixed-schedule baseline
    step_size: float = 0.08                       # CG-PR step scale
    use_cgpr: bool = True                         # False -> plain grad ascent
    dtype: torch.dtype = torch.float32
    engine: str = "cuda_batched"                  # one of ENGINES
    engine_capacity: int = 4096                   # "cuda": taps per tile
    engine_rb: int = 8                            # kernel row-slab height

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def full_resolution_config(camera: Camera = Camera(), max_iters: int = 60,
                           tau: float = 3e-5) -> CmaxConfig:
    """Conventional full-resolution CMAX (no coarse-to-fine): one stage at
    s=1, no subsampling — the paper's 'Full-resolution CMAX' reference."""
    return CmaxConfig(
        camera=camera,
        stages=(StageConfig(scale=1.0, tau=tau, max_iters=max_iters,
                            blur_taps=9, blur_sigma=1.0, keep_ratio=1.0),),
        adaptive=True,
        fixed_iters=(max_iters,),
    )


def fixed_schedule_config(camera: Camera = Camera(),
                          iters: Tuple[int, ...] = (10, 10, 15)
                          ) -> CmaxConfig:
    """Fixed-schedule coarse-to-fine CMAX (the paper's baseline policy)."""
    return dataclasses.replace(CmaxConfig(camera=camera), adaptive=False,
                               fixed_iters=iters)
