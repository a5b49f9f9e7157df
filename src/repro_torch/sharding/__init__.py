"""Partition rules of the parameters, inputs, caches and optimizer state
(counterpart of `repro.sharding`), and their DTensor placements."""
from .rules import (P, PartitionSpec, adafactor_state_specs, batch_specs,
                    cache_specs, distribute_batch, distribute_cache,
                    distribute_model, dp_axes_of, mesh_axes, param_specs,
                    place, port_layout, to_placements, with_divisibility)

__all__ = ["P", "PartitionSpec", "adafactor_state_specs", "batch_specs",
           "cache_specs", "distribute_batch", "distribute_cache",
           "distribute_model", "dp_axes_of", "mesh_axes", "param_specs",
           "place", "port_layout", "to_placements", "with_divisibility"]
