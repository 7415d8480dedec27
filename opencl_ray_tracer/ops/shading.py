"""Shading models.

- `shade_legacy`: the reference's exact depth-fog shading
  (rayTracer.cl:186-196 + Utility.cpp:109-116 normaliseFloat):
      miss => (0, 0, 0, 255)
      hit  => colour * (255 - 255 * t / 180), alpha forced to 255.
  QUIRKS preserved: t > 180 drives the scalar negative (colours go negative
  before the int cast), and colour channels are in [0,1] so output lands in
  [0,255] float before truncation toward zero (C-style int cast,
  rayTracer.cl:198-201).

- `shade_lambert` / `shade_phong`: the BASELINE.json extension — point
  lights, Lambertian diffuse, Phong specular, optional hard shadows.
  Output in the same 0..255 float RGBA domain so the framebuffer/PNG path is
  shared with legacy mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from opencl_ray_tracer.ops.intersect import MISS_T, Hit, any_hit

LEGACY_FOG_MAX = 180.0  # rayTracer.cl:193 normaliseFloat(closest, 180, 0)


def shade_legacy(hit: Hit) -> jax.Array:
    """Depth-fog shading -> float RGBA in the reference's 0..255 domain."""
    scalar = 255.0 - (hit.t / LEGACY_FOG_MAX) * 255.0
    rgba = scalar[..., None] * hit.colour
    rgba = rgba.at[..., 3].set(255.0)
    miss = ~hit.hit
    black = jnp.zeros_like(rgba).at[..., 3].set(255.0)
    return jnp.where(miss[..., None], black, rgba)


def _light_terms(hit: Hit, d, scene, shadows: bool):
    """Per-light (l_dir, dist, attenuated colour, visibility)."""
    lights = scene.lights
    p = hit.point                                    # (..., 3)
    to_l = lights.position - p[..., None, :]         # (..., L, 3)
    dist = jnp.linalg.norm(to_l, axis=-1)            # (..., L)
    l_dir = to_l / jnp.maximum(dist[..., None], 1e-20)

    if shadows:
        # One shadow ray per (pixel, light): offset along the normal to avoid
        # self-intersection, any-hit within the light distance.
        origin = p + 1e-2 * hit.normal
        vis_list = []
        for li in range(lights.position.shape[0]):
            occ = any_hit(origin, l_dir[..., li, :], scene, dist[..., li])
            vis_list.append(~occ)
        vis = jnp.stack(vis_list, axis=-1).astype(jnp.float32)  # (..., L)
    else:
        vis = jnp.ones_like(dist)
    return l_dir, dist, vis


def shade_lambert(hit: Hit, d, scene, shadows: bool = False) -> jax.Array:
    """Ambient + Lambertian diffuse from point lights; 0..255 float RGBA."""
    lights = scene.lights
    l_dir, _, vis = _light_terms(hit, d, scene, shadows)
    n = hit.normal[..., None, :]                     # (..., 1, 3)
    ndotl = jnp.maximum(jnp.sum(n * l_dir, axis=-1), 0.0)     # (..., L)
    li = lights.intensity * ndotl * vis              # (..., L)
    diffuse = jnp.sum(li[..., None] * lights.colour, axis=-2)  # (..., 3)
    albedo = hit.colour[..., :3]
    rgb = albedo * (lights.ambient + diffuse)
    return _finalize(rgb, hit)


def shade_phong(hit: Hit, d, scene, shadows: bool = False) -> jax.Array:
    """Phong: ambient + diffuse + specular; 0..255 float RGBA."""
    lights = scene.lights
    l_dir, _, vis = _light_terms(hit, d, scene, shadows)
    n = hit.normal[..., None, :]
    d_b = jnp.broadcast_to(d, hit.point.shape)
    view = -d_b / jnp.maximum(
        jnp.linalg.norm(d_b, axis=-1, keepdims=True), 1e-20
    )
    ndotl = jnp.maximum(jnp.sum(n * l_dir, axis=-1), 0.0)
    # Reflect l about n: r = 2(n.l)n - l
    r = 2.0 * jnp.sum(n * l_dir, axis=-1, keepdims=True) * n - l_dir
    rdotv = jnp.maximum(jnp.sum(r * view[..., None, :], axis=-1), 0.0)
    spec = lights.spec_strength * rdotv ** lights.shininess

    li_diff = lights.intensity * ndotl * vis
    li_spec = lights.intensity * spec * vis * (ndotl > 0.0)
    diffuse = jnp.sum(li_diff[..., None] * lights.colour, axis=-2)
    specular = jnp.sum(li_spec[..., None] * lights.colour, axis=-2)

    albedo = hit.colour[..., :3]
    rgb = albedo * (lights.ambient + diffuse) + specular
    return _finalize(rgb, hit)


def _finalize(rgb, hit: Hit) -> jax.Array:
    """[0,1] linear RGB -> reference 0..255 float RGBA; miss stays black."""
    rgb = jnp.clip(rgb, 0.0, 1.0) * 255.0
    rgba = jnp.concatenate(
        [rgb, jnp.full(rgb.shape[:-1] + (1,), 255.0, rgb.dtype)], axis=-1
    )
    miss = ~hit.hit
    black = jnp.zeros_like(rgba).at[..., 3].set(255.0)
    return jnp.where(miss[..., None], black, rgba)


def to_int_framebuffer(rgba: jax.Array) -> jax.Array:
    """Float 0..255 RGBA -> int32, truncating toward zero like the C cast at
    rayTracer.cl:198-201 (values can be negative in legacy mode when
    t > 180; that quirk is preserved)."""
    return jnp.trunc(rgba).astype(jnp.int32)


ALPHA_BITS = -16777216  # 0xFF000000 as int32: alpha=255 in packed RGBA words


def pack_framebuffer_words(rgba: jax.Array) -> jax.Array:
    """(..., H, W, 4) 0..255 RGBA (int or float) -> (..., H, W) packed int32
    words R|G<<8|B<<16|255<<24, channels clamped to [0, 255] — the in-graph
    twin of the tiled Pallas kernel's packed output format and of
    utils/image.pack_rgba's byte clamping. Alpha is forced opaque (the
    reference writes 255, rayTracer.cl:187-196)."""
    ch = jnp.clip(rgba, 0.0, 255.0).astype(jnp.int32)
    return (
        ch[..., 0] + ch[..., 1] * 256 + ch[..., 2] * 65536
        + jnp.int32(ALPHA_BITS)
    )
