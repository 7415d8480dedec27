"""Backend discovery & dispatch — the OpenCL host-runtime role.

The reference hand-rolls device discovery (enumerate platforms/devices,
prefer GPU, fall back to device 0 — states/MainState.cpp:1181-1271), runtime
kernel JIT with build-log dump (:1295-1316), and explicit buffer lifecycle
(:666-933). The JAX/XLA equivalents, which this module wraps:

  device discovery   -> jax.devices() / jax.local_devices()
  prefer-accelerator -> JAX's default platform (the GPU when one is present)
  runtime kernel JIT -> XLA trace+compile on first call (with an optional
                        HLO dump, the CL_PROGRAM_BUILD_LOG analogue)
  buffer write/map   -> jax.device_put / np.asarray(device_array)
  NDRange launch     -> the jitted/pallas_call renderer itself

The renderer backend follows from what the platform can lower: the Pallas
kernels compile through Triton for the GPU only, so a GPU process renders
with them and a CPU process with the whole-program XLA renderer. Any other
platform is an error, not a silent fallback.
"""

from __future__ import annotations

import enum
import os
from typing import List, Optional

import jax

from opencl_ray_tracer.utils.log import log_info, log_warning


class Backend(enum.Enum):
    """Renderer backends (the F1 mode toggle, MainState.h:48-52)."""

    REFERENCE = "reference"  # CPU oracle (jnp jitted on host CPU)
    XLA = "xla"              # whole-program XLA on the default device
    PALLAS = "pallas"        # tiled Pallas kernels through Triton (GPU)


_PLATFORM_BACKENDS = {"gpu": Backend.PALLAS, "cpu": Backend.XLA}


def describe_devices() -> List[str]:
    """Device capability dump, the analogue of MainState.cpp:1204-1260."""
    lines = []
    for d in jax.devices():
        lines.append(
            f"id={d.id} platform={d.platform} kind={getattr(d, 'device_kind', '?')}"
        )
    return lines


def log_devices() -> None:
    for line in describe_devices():
        log_info("device: %s", line)


def default_device() -> jax.Device:
    """The device JAX places work on (its platform preference puts the GPU
    first when one is present)."""
    return jax.devices()[0]


def available_backends() -> List[Backend]:
    """The backends that run on this process' platform, accelerated last:
    the CPU oracle and XLA everywhere, the Pallas kernels on a GPU."""
    out = [Backend.REFERENCE, Backend.XLA]
    if default_backend() == Backend.PALLAS:
        out.append(Backend.PALLAS)
    return out


def default_backend(platform: Optional[str] = None) -> Backend:
    """The renderer backend for `platform` (default: JAX's default
    platform): gpu -> the Pallas/Triton kernels, cpu -> XLA."""
    platform = platform or jax.default_backend()
    try:
        return _PLATFORM_BACKENDS[platform]
    except KeyError:
        raise RuntimeError(
            f"no renderer backend for platform {platform!r}; supported: "
            f"{sorted(_PLATFORM_BACKENDS)}"
        ) from None


def resolve_backend(name) -> Backend:
    if name is None:
        return default_backend()
    if isinstance(name, Backend):
        return name
    return Backend(name)


def check_kernel_platform(interpret: bool) -> None:
    """Pallas kernels run compiled on a GPU, or in the Pallas interpreter
    when the caller asks for it. Nothing else: a process without a GPU that
    did not pass interpret=True gets an error, never a quiet interpreter."""
    if interpret:
        return
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            f"the Pallas kernels compile for the GPU only (default platform "
            f"is {platform!r}); pass interpret=True to run them in the "
            f"Pallas interpreter, or use backend='xla'"
        )


def enable_hlo_dump(path: str) -> None:
    """The CL build-log analogue: dump XLA HLO for every compile."""
    os.makedirs(path, exist_ok=True)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_dump_to" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_dump_to={path}".strip()
        log_warning("HLO dump enabled at %s (set before first compile)", path)
