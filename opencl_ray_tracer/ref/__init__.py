from opencl_ray_tracer.ref.tracer import render_reference

__all__ = ["render_reference"]
