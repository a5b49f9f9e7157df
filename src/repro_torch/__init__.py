"""repro_torch: the CMAX-CAMEL estimator in PyTorch, with the engine pass
on CUDA C++ kernels for Hopper (sm_90a), and the LM decode-serving arm.

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
  data     — the seeded synthetic event generator (bit-identical windows),
             the serving layer's bucketing policies and the seeded token
             pipeline (data/lm.py)
  configs  — the paper's pipeline configuration and the ten LM
             architectures (published config + reduced smoke config)
  models   — the LM-family models: config, layers (norms, RoPE, GQA /
             local / cross attention with KV and ring caches, FFNs), MoE,
             the recurrent cells (mLSTM, sLSTM, RG-LRU), the transformer
             (forward, decode_step, caches) and the serving step factories
  convert  — carries configurations, windows, results and LM weights
             across
  telemetry — metrics registry, request spans, decision log, exporters
  costmodel — the profile-driven cost model and the budget scheduler
  serving  — the `Workload` plugin interface, `CmaxWorkload` and
             `LMDecodeWorkload`
  launch   — the async and synchronous estimation services, the
             `python -m repro_torch.launch.serve {cmax,lm}` CLI and the
             device grid (mesh)

Tensor-creating helpers default to the CUDA device and raise when no card
is present; estimation entry points run on the device of their inputs.
The package never imports JAX or `repro`.
"""
__version__ = "0.1.0"
