# Launch layer: the serving entry point (`python -m repro_torch.launch.serve
# cmax|lm`), the single-device training entry point (`python -m
# repro_torch.launch.train`) and the single-process device grid (`mesh`).
# The reference's production mesh and dry-run are not ported yet.
