# Launch layer: the serving entry point (`python -m repro_torch.launch.serve
# cmax`) and the single-process device grid (`mesh`). The reference's
# production mesh, dry-run and training launchers are not ported yet.
