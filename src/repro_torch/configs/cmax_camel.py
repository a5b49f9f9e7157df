"""The paper's own pipeline configuration: CMAX-CAMEL on a DAVIS240C
(240x180) with 40,000-event windows, three coarse-to-fine stages
(s = 1/4, 1/2, 1; 3/5/9-tap Gaussians; keep-ratio rho_s = s) and the
runtime-adaptive controller (Alg. 1). Engine: the port's default,
"cuda_batched"."""
from repro_torch.core.types import Camera, CmaxConfig, \
    fixed_schedule_config, full_resolution_config

CAMERA = Camera()                         # DAVIS240C
CONFIG = CmaxConfig(camera=CAMERA)        # runtime-adaptive (the paper)
FIXED = fixed_schedule_config(CAMERA)     # fixed-schedule baseline
FULLRES = full_resolution_config(CAMERA)  # conventional full-res CMAX
EVENTS_PER_WINDOW = 40000
