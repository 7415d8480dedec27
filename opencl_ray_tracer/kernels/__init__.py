from opencl_ray_tracer.kernels.fwd_tiled import (
    TileBins,
    bin_scene,
    render_tiled,
    render_tiled_packed,
)
from opencl_ray_tracer.kernels.soft_tiled import render_soft_tiled

__all__ = [
    "TileBins",
    "bin_scene",
    "render_tiled",
    "render_tiled_packed",
    "render_soft_tiled",
]
