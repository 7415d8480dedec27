from opencl_ray_tracer.runtime.backend import (
    Backend,
    available_backends,
    check_kernel_platform,
    default_backend,
    default_device,
    describe_devices,
    enable_hlo_dump,
    log_devices,
    resolve_backend,
)

__all__ = [
    "Backend",
    "available_backends",
    "check_kernel_platform",
    "default_backend",
    "default_device",
    "describe_devices",
    "enable_hlo_dump",
    "log_devices",
    "resolve_backend",
]
