"""Single-device LM training (counterpart of `repro.train`): optimizers
with int8 error-feedback compression, checkpointing, the fault-tolerance
harness and the fault-tolerant loop."""
