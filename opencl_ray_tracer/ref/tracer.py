"""CPU oracle tracer — the reference's "slow twin" backend.

The reference keeps a deliberately simple serial CPU tracer
(states/MainState.cpp:936-972) as the de-facto correctness oracle for its
OpenCL kernel (the F1 cross-check, SURVEY.md §4.1). This module is that
component here: a straight-line jax.numpy implementation of the
exact contract (SURVEY.md §7 items 1-5), jitted on the *CPU* backend, that the
Pallas/XLA paths are validated against with allclose.

It is intentionally the clearest possible statement of the semantics, not a
fast renderer — row-chunked only so full frames fit in host memory.

(Note: the reference CPU tracer does its triangle math in double while the
OpenCL kernel uses float (MainState.cpp:257 vs rayTracer.cl:37) — its two
backends do NOT bit-match each other at triangle edges. Ours both use float32
so the cross-check is exact rather than approximate.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opencl_ray_tracer.camera import Camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.ops import (
    nearest_hit,
    shade_lambert,
    shade_legacy,
    shade_phong,
    to_int_framebuffer,
)


def _trace_rows(scene, o, d, *, shading: str, shadows: bool):
    """Trace a block of rays: o, d (..., 3) -> RGBA float (..., 4)."""
    hit = nearest_hit(o, d, scene)
    if shading == "legacy":
        return shade_legacy(hit)
    if shading == "lambert":
        return shade_lambert(hit, d, scene, shadows=shadows)
    if shading == "phong":
        return shade_phong(hit, d, scene, shadows=shadows)
    raise ValueError(f"unknown shading mode {shading!r}")


@functools.partial(
    jax.jit, static_argnames=("height", "width", "shading", "shadows", "row_chunk")
)
def _render_oracle(
    scene,
    camera: Camera,
    height: int,
    width: int,
    shading: str,
    shadows: bool,
    row_chunk: int = 64,
):
    o, d = camera.rays(height, width)                 # (H, W, 3) each

    def do_chunk(args):
        oc, dc = args
        return _trace_rows(scene, oc, dc, shading=shading, shadows=shadows)

    if height % row_chunk == 0 and height > row_chunk:
        o = o.reshape(height // row_chunk, row_chunk, width, 3)
        d = d.reshape(height // row_chunk, row_chunk, width, 3)
        rgba = jax.lax.map(do_chunk, (o, d))
        rgba = rgba.reshape(height, width, 4)
    else:
        rgba = do_chunk((o, d))
    return rgba


def render_reference(scene, camera: Camera, config: RenderConfig) -> jax.Array:
    """Render on the CPU oracle. Returns the framebuffer:
    int32 (H, W, 4) in "int" mode (bit-exact reference semantics) or float32
    (H, W, 4) in "float" mode."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        scene = jax.device_put(scene, cpu)
        camera = jax.device_put(camera, cpu)
        rgba = _render_oracle(
            scene,
            camera,
            height=config.height,
            width=config.width,
            shading=config.shading,
            shadows=config.shadows,
        )
        if config.framebuffer_dtype == "int":
            return to_int_framebuffer(rgba)
        return rgba
