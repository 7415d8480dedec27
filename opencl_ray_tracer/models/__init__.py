from opencl_ray_tracer.models.renderer import Renderer, get_renderer, render
from opencl_ray_tracer.models.xla_backend import render_xla, trace_pixels

__all__ = ["Renderer", "get_renderer", "render", "render_xla", "trace_pixels"]
