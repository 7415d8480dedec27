"""XLA backend: the whole pipeline as one jitted jnp program on the default
device.

This is the "let XLA fuse it" renderer: ray gen, intersection, nearest-hit
and shading are written at the jnp level (ops/) and compiled as one program.
It is the CPU renderer, the tiled kernel's overflow fallback, and the plain
form the Pallas kernel is timed against.

Memory is bounded by mapping over row chunks with lax.map (sequential, so
peak intermediate size is chunk*W*numPrims, not H*W*numPrims). Heights that
are not a multiple of the chunk are padded to one and cropped after.
"""

from __future__ import annotations

import functools

import jax

from opencl_ray_tracer.camera import Camera, map_row_chunks
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.ops import (
    nearest_hit,
    shade_lambert,
    shade_legacy,
    shade_phong,
    to_int_framebuffer,
)


def trace_pixels(scene, o, d, *, shading: str, shadows: bool):
    """Trace arbitrary ray bundles: o/d (..., 3) -> RGBA float (..., 4)."""
    hit = nearest_hit(o, d, scene)
    if shading == "legacy":
        return shade_legacy(hit)
    if shading == "lambert":
        return shade_lambert(hit, d, scene, shadows=shadows)
    if shading == "phong":
        return shade_phong(hit, d, scene, shadows=shadows)
    raise ValueError(f"unknown shading mode {shading!r}")


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "shading", "shadows", "row_chunk", "as_int"),
)
def render_xla_jit(
    scene,
    camera: Camera,
    height: int,
    width: int,
    shading: str = "legacy",
    shadows: bool = False,
    row_chunk: int = 32,
    as_int: bool = True,
):
    def do_chunk(args):
        oc, dc = args
        return trace_pixels(scene, oc, dc, shading=shading, shadows=shadows)

    rgba = map_row_chunks(do_chunk, camera, height, width, row_chunk)

    return to_int_framebuffer(rgba) if as_int else rgba


def render_xla(scene, camera: Camera, config: RenderConfig) -> jax.Array:
    return render_xla_jit(
        scene,
        camera,
        height=config.height,
        width=config.width,
        shading=config.shading,
        shadows=config.shadows,
        as_int=config.framebuffer_dtype == "int",
    )
