"""repro_torch: the CMAX-CAMEL estimator in PyTorch, with the engine pass
on CUDA C++ kernels for Hopper (sm_90a).

A second package beside the JAX reference `repro`, with the same
subpackage and module names so each piece has an obvious counterpart:

  core     — types, warp, IWE, contrast, sorting, CG-PR, adaptive control,
             the estimation pipeline (batched masked lockstep), measured
             locality statistics (energy) and data parallelism over a
             device grid (distributed)
  kernels  — the hand-written kernels (the batched engine-pass kernel;
             the per-window tile accumulation and streaming blur
             statistics), their plain PyTorch versions and the prologues
             that feed them
  data     — the seeded synthetic event generator (bit-identical windows)
             and the serving layer's bucketing policies
  configs  — the paper's pipeline configuration
  convert  — carries configurations, windows and results across
  telemetry — metrics registry, request spans, decision log, exporters
  costmodel — the profile-driven cost model and the budget scheduler
  serving  — the `Workload` plugin interface and `CmaxWorkload`
  launch   — the async and synchronous estimation services, the
             `python -m repro_torch.launch.serve cmax` CLI and the device
             grid (mesh)

Tensor-creating helpers default to the CUDA device and raise when no card
is present; estimation entry points run on the device of their inputs.
The package never imports JAX or `repro`.
"""
__version__ = "0.1.0"
