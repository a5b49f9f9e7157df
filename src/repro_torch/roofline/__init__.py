"""Roofline analysis (counterpart of `repro.roofline`): the three-term
per-cell roofline of the LM configs on the H100 and the CMAX kernels'
roofline; `report` renders the dry-run records (`launch.dryrun`)."""
from .analysis import (F32_FLOPS, HW, analytic_flops, analytic_hbm_bytes,
                       cmax_megakernel_costs, cmax_scatter_costs,
                       cmax_unfused_costs, cuda_blur_costs,
                       cuda_megakernel_costs, cuda_tile_costs, default_hw,
                       kernel_roofline, roofline_terms,
                       summarize_cell)

__all__ = ["F32_FLOPS", "HW", "analytic_flops", "analytic_hbm_bytes",
           "cmax_megakernel_costs", "cmax_scatter_costs",
           "cmax_unfused_costs", "cuda_blur_costs", "cuda_megakernel_costs",
           "cuda_tile_costs", "default_hw",
           "kernel_roofline", "roofline_terms", "summarize_cell"]
