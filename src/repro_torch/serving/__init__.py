"""Workload-plugin serving substrate (DESIGN.md §Workload plugins;
counterpart of `repro.serving`).

The batched services in `repro_torch.launch.serve` are workload-agnostic
schedulers; everything workload-specific — bucketing, batch
materialization, the executable factory, per-stream carried state, QoS
budget allocation, harvest — lives behind the `Workload` interface
defined here. Two plugins ship: `CmaxWorkload`, the paper's
contrast-maximization pipeline, and `LMDecodeWorkload`, LM decode in
variable-length token chunks.
"""
from .workload import (CmaxWorkload, LMChunkResult, LMDecodeWorkload,
                       SlotResult, Workload)

__all__ = ["Workload", "CmaxWorkload", "LMDecodeWorkload", "LMChunkResult",
           "SlotResult"]
