from opencl_ray_tracer.utils.log import (
    get_logger,
    log_error,
    log_info,
    log_warning,
    set_level,
)
from opencl_ray_tracer.utils.timer import (
    DeltaTime,
    PerformanceCounter,
    SimpleTimer,
    now_ns,
    time_fn,
)
from opencl_ray_tracer.utils.display import render_ansi, show
from opencl_ray_tracer.utils.image import pack_rgba, read_png, write_png
from opencl_ray_tracer.utils import mathutil, memory, platform_info, profiling, rng

__all__ = [
    "get_logger",
    "log_error",
    "log_info",
    "log_warning",
    "set_level",
    "DeltaTime",
    "PerformanceCounter",
    "SimpleTimer",
    "now_ns",
    "time_fn",
    "pack_rgba",
    "read_png",
    "render_ansi",
    "show",
    "write_png",
    "mathutil",
    "memory",
    "platform_info",
    "profiling",
    "rng",
]
