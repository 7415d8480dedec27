"""opencl_ray_tracer — a differentiable ray tracer in JAX/Pallas for GPUs.

A from-scratch re-design of the capabilities of RichardHancock/OpenCL-Ray-Tracer:

- per-pixel primary-ray pipeline (camera ray gen -> sphere/triangle intersection
  -> nearest hit -> shading -> RGBA framebuffer), reproducing the reference's
  exact "legacy" semantics (rayTracer.cl:111-202) for validation, plus
  Lambertian/Phong shading with point lights and hard shadows,
- tiled, culled Pallas kernels (through Triton) for the GPU compute path,
- a CPU/XLA oracle tracer (the reference's dual-backend cross-check,
  states/MainState.cpp:936-972) used as the correctness anchor,
- soft/reparameterized edge handling so the whole pipeline is differentiable
  w.r.t. sphere centers/radii, cube transforms, colours and light positions,
- mesh-sharded multi-device rendering (image rows sharded, scene replicated,
  scene-parameter grads all-reduced with one psum) via jax.sharding +
  shard_map.

Public API lives here; subpackages:
  scene/     scene model (spheres SoA, cubes, lights) + built-in scene library
  camera     affine ray-bundle cameras (legacy ortho + pinhole)
  ops/       vectorized intersection + shading math (jnp)
  ref/       CPU oracle tracer (reference semantics, the "slow twin")
  kernels/   tiled Pallas kernels through Triton (forward + soft backward)
  diff/      soft differentiable renderer + custom VJPs
  parallel/  device mesh, sharded rendering, distributed init
  models/    renderer families (Legacy / Lambert / Phong / Soft) + inverse rendering
  runtime/   backend discovery & dispatch (the OpenCL-host-runtime role)
  utils/     logging, timers, RNG, image/PNG IO (native-accelerated)
  app/       app shell: state machine, input, frame loop, benchmark harness
  native/    C++ runtime pieces (PNG codec, timer, framebuffer pack) via ctypes
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def compile_cache_dir(environ=_os.environ):
    """Where the persistent compilation cache lives: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself and the package
    sets no other), else a fixed directory inside the checkout."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)

from opencl_ray_tracer.config import RenderConfig, Settings
from opencl_ray_tracer.camera import Camera, legacy_ortho_camera, pinhole_camera
from opencl_ray_tracer.scene import (
    Scene,
    Cube,
    Lights,
    create_scene,
    create_scene1,
    create_scene2,
    create_scene3,
    random_scene,
)
from opencl_ray_tracer.models import (
    Renderer,
    get_renderer,
    render,
)
from opencl_ray_tracer.runtime import Backend, available_backends, default_backend

__all__ = [
    "RenderConfig",
    "Settings",
    "Camera",
    "legacy_ortho_camera",
    "pinhole_camera",
    "Scene",
    "Cube",
    "Lights",
    "create_scene",
    "create_scene1",
    "create_scene2",
    "create_scene3",
    "random_scene",
    "Renderer",
    "get_renderer",
    "render",
    "Backend",
    "available_backends",
    "default_backend",
    "compile_cache_dir",
]
