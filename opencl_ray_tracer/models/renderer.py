"""Renderer facade — the model families of this framework.

A "model" here is a renderer configuration: shading model x backend x
hard/soft. The facade dispatches to:

  reference -> ref/tracer.py      (CPU oracle, the reference's CPU mode)
  xla       -> models/xla_backend (whole-program XLA on the default device)
  pallas    -> kernels/           (tiled Pallas kernels through Triton, the
                                   OpenCL-kernel equivalent —
                                   rayTracer.cl:111-202 role)

plus named convenience families mirroring how the reference exposes its
pipeline (legacy depth-fog) and the BASELINE.json extensions (lambert /
phong / soft-differentiable).
"""

from __future__ import annotations

from typing import Optional, Union

import jax

from opencl_ray_tracer.camera import Camera, legacy_ortho_camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.runtime import Backend, resolve_backend

# Sub-pixel sample offsets per MSAA level, in pixel units relative to the
# pixel's nominal sample point. 2x = diagonal pair, 4x = rotated grid
# (RGSS), 8x/16x = 8-rook / 4x4 ordered grid — the standard GL/D3D
# patterns the reference's SDL_GL_MULTISAMPLESAMPLES attribute would
# select from (Platform.cpp:274-310 path, defaultSettings.xml:6).
MSAA_OFFSETS = {
    2: ((0.25, 0.25), (-0.25, -0.25)),
    4: ((-0.125, -0.375), (0.375, -0.125), (-0.375, 0.125), (0.125, 0.375)),
    8: tuple(
        ((i + 0.5) / 8.0 - 0.5, (((i * 3) % 8) + 0.5) / 8.0 - 0.5)
        for i in range(8)
    ),
    16: tuple(
        ((ix + 0.5) / 4.0 - 0.5, (iy + 0.5) / 4.0 - 0.5)
        for iy in range(4)
        for ix in range(4)
    ),
}


def render(
    scene,
    camera: Optional[Camera] = None,
    config: Optional[RenderConfig] = None,
    backend: Union[Backend, str, None] = None,
) -> jax.Array:
    """Render a frame. Returns the framebuffer (H, W, 4), int32 or float32
    depending on config.framebuffer_dtype.

    config.msaa > 1 supersamples: `msaa` sub-pixel-jittered renders through
    the affine camera bundle (Camera.shift_subpixel — exact for both camera
    families), box-filtered, quantized once at the end for int framebuffers
    (resolve-then-quantize, the GL multisample-resolve order)."""
    config = config or RenderConfig()
    camera = camera or legacy_ortho_camera()

    if config.msaa > 1:
        import jax.numpy as jnp

        sample_cfg = config.replace(msaa=0, framebuffer_dtype="float")
        acc = None
        for dx, dy in MSAA_OFFSETS[config.msaa]:
            img = render(scene, camera.shift_subpixel(dx, dy), sample_cfg,
                         backend=backend)
            acc = img if acc is None else acc + img
        out = acc * (1.0 / config.msaa)
        if config.framebuffer_dtype == "int":
            out = jnp.round(out).astype(jnp.int32)
        elif config.framebuffer_dtype == "packed":
            from opencl_ray_tracer.ops.shading import pack_framebuffer_words

            out = pack_framebuffer_words(jnp.round(out))
        return out

    b = resolve_backend(backend if backend is not None else config.backend)

    # Packed framebuffers: native on the tiled Pallas path (the kernel emits
    # the words directly); other backends render float and pack in-graph.
    if config.framebuffer_dtype == "packed" and not (
        b == Backend.PALLAS and not config.soft
    ):
        from opencl_ray_tracer.ops.shading import pack_framebuffer_words

        rgba = render(
            scene, camera, config.replace(framebuffer_dtype="float"),
            backend=backend,
        )
        return pack_framebuffer_words(rgba)

    if config.soft:
        if b == Backend.PALLAS:
            from opencl_ray_tracer.kernels.soft_tiled import (
                render_soft_tiled,
            )

            return render_soft_tiled(scene, camera, config)
        from opencl_ray_tracer.diff import render_soft

        return render_soft(scene, camera, config)

    if b == Backend.REFERENCE:
        from opencl_ray_tracer.ref import render_reference

        return render_reference(scene, camera, config)
    if b == Backend.XLA:
        from opencl_ray_tracer.models.xla_backend import render_xla

        return render_xla(scene, camera, config)
    if b == Backend.PALLAS:
        # Both camera families take the tiled+culled kernel (affine fast
        # path for shared-direction, projective for pinhole); the XLA
        # renderer is the overflow fallback inside render_tiled.
        from opencl_ray_tracer.kernels.fwd_tiled import render_tiled

        return render_tiled(scene, camera, config)
    raise ValueError(f"unknown backend {b}")


class Renderer:
    """Stateful facade bundling a config + camera, with per-backend render
    methods — the object a user of the reference's MainState would reach for."""

    def __init__(
        self,
        config: Optional[RenderConfig] = None,
        camera: Optional[Camera] = None,
    ):
        self.config = (config or RenderConfig()).validate()
        self.camera = camera or legacy_ortho_camera()

    def render(self, scene, backend: Union[Backend, str, None] = None) -> jax.Array:
        return render(scene, self.camera, self.config, backend=backend)

    def render_cpu(self, scene) -> jax.Array:
        """The reference's CPU mode (executeRayTracerCPU equivalent)."""
        return self.render(scene, backend=Backend.REFERENCE)

    def render_accelerated(self, scene) -> jax.Array:
        """The reference's OpenCL mode (executeRayTracerOpenCL equivalent)."""
        return self.render(scene, backend=None)


# -- named families ---------------------------------------------------------

def get_renderer(family: str, width: int = 640, height: int = 480, **kw) -> Renderer:
    """Renderer families by name:

    legacy         — exact reference pipeline (depth fog, int framebuffer)
    lambert        — point lights + Lambertian diffuse
    phong          — Phong + hard shadows
    soft / diff    — soft-edge differentiable renderer (float framebuffer)
    """
    presets = {
        "legacy": dict(shading="legacy", framebuffer_dtype="int"),
        "lambert": dict(shading="lambert", framebuffer_dtype="float"),
        "phong": dict(shading="phong", shadows=True, framebuffer_dtype="float"),
        "soft": dict(shading="lambert", soft=True, framebuffer_dtype="float"),
        "diff": dict(shading="lambert", soft=True, framebuffer_dtype="float"),
    }
    if family not in presets:
        raise ValueError(f"unknown renderer family {family!r}; have {list(presets)}")
    opts = {**presets[family], **kw}
    return Renderer(RenderConfig(width=width, height=height, **opts).validate())
