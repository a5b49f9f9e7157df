# Kernel layer: the engine pass as a hand-written CUDA C++ kernel for
# Hopper (csrc/megakernel.cu), its plain PyTorch version, and the binning
# prologue that feeds it.
from .megakernel import megakernel_stats, megakernel_stats_plain
from .ops import TapBins, batched_engine_pass, batched_engine_stats, bin_taps

__all__ = ["TapBins", "batched_engine_pass", "batched_engine_stats",
           "bin_taps", "megakernel_stats", "megakernel_stats_plain"]
