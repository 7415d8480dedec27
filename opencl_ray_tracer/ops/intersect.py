"""Vectorized ray-primitive intersection ops (pure jnp, vectorized).

Reproduces the reference's exact hit semantics, with every branch rewritten
as select/where chains (the branchy OpenCL code at rayTracer.cl:54-97 cannot
vectorize; this form maps 1:1 onto vector lanes):

- Sphere: geometric method (rayTracer.cl:80-109). QUIRKS preserved:
  * miss returns 0.0 (not -1), so a true hit at exactly t=0 is discarded by
    the caller's `distance == 0.0f -> continue` (rayTracer.cl:176-177);
  * tca < 0 (center behind origin) => miss;
  * returns t0 = tca - thc which may be NEGATIVE for origins inside the
    sphere — and a negative t WINS the nearest-hit min (no lower clamp).
- Triangle: Möller–Trumbore with EPSILON=1e-6 (rayTracer.cl:37-78). QUIRK:
  t is unconstrained — triangles BEHIND the origin (t<0) count as hits and
  win the min, exactly as in the reference.
- Nearest hit: running min initialized to 300000.0 (rayTracer.cl:136-137);
  cubes processed before spheres, sphere wins ties only strictly
  (`distance < closest`, rayTracer.cl:179), triangle ties go to the earliest
  triangle (strict `t < closest`, rayTracer.cl:162).

All functions broadcast over arbitrary leading pixel dims.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

EPSILON = 1e-6          # rayTracer.cl:4
MISS_T = 300000.0       # rayTracer.cl:137 sentinel
SHADOW_EPS = 1e-3


def intersect_spheres(o, d, centers, radii):
    """Sphere hit distances with the reference's 0.0-miss sentinel.

    o: (..., 3) origins; d: (..., 3) or (3,) directions;
    centers: (S, 3); radii: (S,). Returns t: (..., S).
    """
    o = o[..., None, :]                      # (..., 1, 3)
    d = jnp.broadcast_to(d, o.shape[:-2] + (3,))[..., None, :]
    L = centers - o                          # (..., S, 3)
    tca = jnp.sum(L * d, axis=-1)            # (..., S)
    d2 = jnp.sum(L * L, axis=-1) - tca * tca
    r2 = radii * radii
    # sqrt argument clamped for the miss lanes (result discarded there).
    thc = jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
    t0 = tca - thc
    hit = (tca >= 0.0) & (d2 <= r2)
    return jnp.where(hit, t0, 0.0)


def intersect_tris(o, d, v0, e1, e2):
    """Möller–Trumbore over a triangle array.

    o: (..., 3); d: (..., 3) or (3,); v0/e1/e2: (T, 3) with e1 = v1 - v0,
    e2 = v2 - v0. Returns (t, valid): (..., T) each.
    """
    o = o[..., None, :]                              # (..., 1, 3)
    d = jnp.broadcast_to(d, o.shape[:-2] + (3,))[..., None, :]

    pvec = jnp.cross(d, e2)                          # (..., T, 3)
    det = jnp.sum(e1 * pvec, axis=-1)                # (..., T)
    det_ok = jnp.abs(det) >= EPSILON
    # Guard the reciprocal on dead lanes; result is masked out by det_ok.
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)

    tvec = o - v0                                    # (..., T, 3)
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det

    valid = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


class Hit(NamedTuple):
    """Nearest-hit result over all primitives for each pixel."""

    t: jax.Array        # (...,) distance, MISS_T when nothing hit
    colour: jax.Array   # (..., 4) winning primitive RGBA (black RGBA on miss)
    normal: jax.Array   # (..., 3) outward normal flipped against the ray
    hit: jax.Array      # (...,) bool
    point: jax.Array    # (..., 3) hit position o + t*d


def nearest_hit(o, d, scene) -> Hit:
    """Full nearest-hit resolution with reference ordering semantics.

    scene: a Scene pytree (unpacked layout). Broadcasts over leading dims of
    o. Degenerate inputs (0 spheres / 0 tris) are handled statically.
    """
    lead = o.shape[:-1]
    d_b = jnp.broadcast_to(d, lead + (3,))

    best_t = jnp.full(lead, MISS_T, jnp.float32)
    best_colour = jnp.zeros(lead + (4,), jnp.float32)
    best_normal = jnp.zeros(lead + (3,), jnp.float32)

    # --- cubes first (rayTracer.cl:140-169) ---
    if scene.num_triangles:
        v0 = scene.tri_verts[:, 0, :]
        e1 = scene.tri_verts[:, 1, :] - v0
        e2 = scene.tri_verts[:, 2, :] - v0
        t, valid = intersect_tris(o, d, v0, e1, e2)
        t = jnp.where(valid, t, MISS_T)
        # First minimal index == loop order tie-break (strict <).
        idx = jnp.argmin(t, axis=-1)
        t_tri = jnp.take_along_axis(t, idx[..., None], axis=-1)[..., 0]
        tri_won = t_tri < best_t
        best_t = jnp.where(tri_won, t_tri, best_t)
        best_colour = jnp.where(
            tri_won[..., None], scene.tri_colour[idx], best_colour
        )
        n = jnp.cross(e1, e2)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        n_hit = n[idx]                                  # (..., 3)
        # Flip toward the ray origin side.
        n_hit = jnp.where(
            jnp.sum(n_hit * d_b, axis=-1, keepdims=True) > 0, -n_hit, n_hit
        )
        best_normal = jnp.where(tri_won[..., None], n_hit, best_normal)

    # --- spheres second, strict < (rayTracer.cl:172-184) ---
    if scene.num_spheres:
        ts = intersect_spheres(o, d, scene.sphere_origin, scene.sphere_radius)
        ts = jnp.where(ts == 0.0, MISS_T, ts)   # 0.0-miss sentinel -> +inf-ish
        sidx = jnp.argmin(ts, axis=-1)
        t_sph = jnp.take_along_axis(ts, sidx[..., None], axis=-1)[..., 0]
        sph_won = t_sph < best_t
        best_t = jnp.where(sph_won, t_sph, best_t)
        best_colour = jnp.where(
            sph_won[..., None], scene.sphere_colour[sidx], best_colour
        )
        centre = scene.sphere_origin[sidx]              # (..., 3)
        radius = scene.sphere_radius[sidx][..., None]
        p = o + t_sph[..., None] * d_b
        ns = (p - centre) / jnp.maximum(radius, 1e-20)
        best_normal = jnp.where(sph_won[..., None], ns, best_normal)

    hit = best_t < MISS_T
    point = o + best_t[..., None] * d_b
    return Hit(t=best_t, colour=best_colour, normal=best_normal, hit=hit, point=point)


def any_hit(o, d, scene, t_max):
    """Occlusion query for shadow rays: does anything lie in (eps, t_max)?

    o: (..., 3) shadow-ray origins; d: (..., 3) normalized directions;
    t_max: (...,) distance to the light. Returns bool (...,).
    """
    lead = o.shape[:-1]
    occluded = jnp.zeros(lead, bool)

    if scene.num_triangles:
        v0 = scene.tri_verts[:, 0, :]
        e1 = scene.tri_verts[:, 1, :] - v0
        e2 = scene.tri_verts[:, 2, :] - v0
        t, valid = intersect_tris(o, d, v0, e1, e2)
        blocked = valid & (t > SHADOW_EPS) & (t < t_max[..., None])
        occluded |= jnp.any(blocked, axis=-1)

    if scene.num_spheres:
        ts = intersect_spheres(o, d, scene.sphere_origin, scene.sphere_radius)
        blocked = (ts != 0.0) & (ts > SHADOW_EPS) & (ts < t_max[..., None])
        occluded |= jnp.any(blocked, axis=-1)

    return occluded
