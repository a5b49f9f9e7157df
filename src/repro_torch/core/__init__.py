# The paper's primary contribution: runtime-adaptive, memory-efficient
# contrast maximization (CMAX-CAMEL), as plain PyTorch functions.
from .types import (Camera, CmaxConfig, EventWindow, StageConfig,
                    fixed_schedule_config, full_resolution_config)
from .geometry import WarpOut, rotational_flow, warp_events, warp_points
from .iwe import accumulate, build_iwe, build_iwe_only, event_deltas
from .contrast import (blur_separable, gaussian_taps, objective_direct,
                       objective_streaming, stats_to_objective,
                       streaming_stats, variance_of)
from .sorting import SortTables, retained_window, sort_events, stage_policy
from .adaptive import (BudgetedGainThresholdController,
                       GainThresholdController, gain, should_stay)
from . import cgpr, energy
from .pipeline import (StageTrace, WindowResult, estimate_batch,
                       estimate_batch_budgeted, estimate_batch_donated,
                       estimate_sequence, estimate_streams, estimate_window,
                       estimate_window_budgeted, estimate_windows_parallel,
                       make_engine_pass)

__all__ = [
    "Camera", "CmaxConfig", "EventWindow", "StageConfig",
    "fixed_schedule_config", "full_resolution_config",
    "WarpOut", "rotational_flow", "warp_events", "warp_points",
    "accumulate", "build_iwe", "build_iwe_only", "event_deltas",
    "blur_separable", "gaussian_taps", "objective_direct",
    "objective_streaming", "stats_to_objective", "streaming_stats",
    "variance_of",
    "SortTables", "retained_window", "sort_events", "stage_policy",
    "BudgetedGainThresholdController", "GainThresholdController",
    "gain", "should_stay", "cgpr", "energy",
    "StageTrace", "WindowResult", "estimate_batch",
    "estimate_batch_budgeted", "estimate_batch_donated",
    "estimate_sequence", "estimate_streams",
    "estimate_window", "estimate_window_budgeted",
    "estimate_windows_parallel", "make_engine_pass",
]
