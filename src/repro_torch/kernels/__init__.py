# Kernel layer: the hand-written CUDA C++ kernels for Hopper (csrc/), each
# with its plain PyTorch version, and the prologues that feed them: the
# batched engine-pass megakernel, and the per-window engine's tile
# accumulation and streaming blur statistics.
from .blur_stats import blur_stats_streaming, blur_stats_streaming_plain
from .iwe_accum import tile_accumulate, tile_accumulate_plain
from .megakernel import megakernel_stats, megakernel_stats_plain
from .ops import (BatchedEngineOut, IweAccumOut, TapBins, TilePack,
                  batched_engine_pass, batched_engine_stats, bin_taps,
                  blur_stats, fused_engine_pass, iwe_accum, pack_tiles)

__all__ = ["BatchedEngineOut", "IweAccumOut", "TapBins", "TilePack",
           "batched_engine_pass", "batched_engine_stats", "bin_taps", "blur_stats",
           "blur_stats_streaming", "blur_stats_streaming_plain",
           "fused_engine_pass", "iwe_accum", "megakernel_stats",
           "megakernel_stats_plain", "pack_tiles", "tile_accumulate",
           "tile_accumulate_plain"]
