# Launch layer: the serving entry point (`python -m repro_torch.launch.serve
# cmax|lm`), the training entry point (`python -m repro_torch.launch.train`,
# one card or `torchrun`), the device grids and the production mesh
# (`mesh`), and the multi-pod dry run on a fake process group (`python -m
# repro_torch.launch.dryrun`).
