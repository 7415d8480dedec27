"""Platform bootstrap / system info — the reference's Platform subsystem
(Platform.cpp:39-184 initSDL + :381-400 checkFeatureSupport + system
logging). Headless equivalent: device discovery + host capability dump,
logged at startup by the CLI."""

from __future__ import annotations

import os
import platform as _platform
from typing import Dict, List

import jax

from opencl_ray_tracer.utils.log import log_info
from opencl_ray_tracer.utils.memory import get_host_memory_usage_bytes


def cpu_features() -> List[str]:
    """Host SIMD feature detection (checkFeatureSupport role)."""
    feats = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = set(line.split(":")[1].split())
                    for name in ("sse2", "sse4_1", "sse4_2", "avx", "avx2",
                                 "avx512f", "fma"):
                        if name in flags:
                            feats.append(name.upper())
                    break
    except OSError:
        pass
    return feats


def system_info() -> Dict[str, object]:
    devs = jax.devices()
    return {
        "os": f"{_platform.system()} {_platform.release()}",
        "python": _platform.python_version(),
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "devices": [
            f"{d.platform}:{getattr(d, 'device_kind', '?')}#{d.id}" for d in devs
        ],
        "process_count": jax.process_count(),
        "cpu_count": os.cpu_count(),
        "cpu_features": cpu_features(),
        "host_rss_mb": round(get_host_memory_usage_bytes() / 1e6, 1),
    }


def log_system_info() -> None:
    """The reference logs all of this at Platform::initSDL time."""
    for k, v in system_info().items():
        log_info("%s: %s", k, v)
