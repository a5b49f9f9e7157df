# Launch layer: the serving entry point (`python -m repro_torch.launch.serve
# cmax`). The reference's mesh, dry-run and training launchers are not
# ported yet.
