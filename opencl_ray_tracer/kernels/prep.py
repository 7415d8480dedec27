"""Kernel operand preparation (pure jnp, differentiable; no kernel here).

Everything the tiled kernels read besides their per-tile candidate tables:
the flat camera/material/light parameter vector, the per-primitive
attribute rows the forward kernel gathers its winner's colour and normal
from, and the shared-direction camera's affine intersection coefficients.
All of it is ordinary XLA work that runs once per frame, outside the
kernels, and is differentiated by plain jax.vjp in the soft backward.
"""

from __future__ import annotations

import jax.numpy as jnp

from opencl_ray_tracer.camera import Camera
from opencl_ray_tracer.ops.intersect import EPSILON

# params vector layout: camera affine bundle + material + lights.
_P_O0, _P_DOX, _P_DOY, _P_D0, _P_DDX, _P_DDY = 0, 3, 6, 9, 12, 15
_P_AMBIENT, _P_SPEC, _P_SHINE = 18, 19, 20
_P_LIGHTS = 21  # then per light: pos(3) colour(3) intensity(1)
_LIGHT_STRIDE = 7


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _camera_params(camera: Camera, lights):
    parts = [
        camera.o0, camera.dox, camera.doy, camera.d0, camera.ddx, camera.ddy,
        jnp.stack([lights.ambient, lights.spec_strength, lights.shininess]),
    ]
    n_lights = lights.position.shape[0]
    for li in range(n_lights):
        parts.append(lights.position[li])
        parts.append(lights.colour[li])
        parts.append(lights.intensity[li : li + 1])
    return jnp.concatenate([p.astype(jnp.float32) for p in parts])


def _prim_attrs(packed):
    """PackedScene -> per-primitive attribute rows.

    tri attrs: (Tp, 8) rows [r, g, b, nx, ny, nz, 0, 0] (unit normals)
    sph attrs: (Sp, 8) rows [r, g, b, cx, cy, cz, 1/rad, 1]
    (1/rad, not rad: the kernel rebuilds sphere normals as (p - c) * irad —
    a multiply, not a divide; padded radius-0 spheres store 0.)
    """
    n = jnp.cross(packed.tri_e1.T, packed.tri_e2.T)  # (Tp, 3)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    tp = packed.padded_tris
    tri_attr = jnp.concatenate(
        [packed.tri_colour.T[:, :3], n, jnp.zeros((tp, 2), jnp.float32)], axis=1
    )
    sp = packed.padded_spheres
    rad = packed.sph_radius.T
    irad = jnp.where(rad > 0, 1.0 / jnp.where(rad > 0, rad, 1.0), 0.0)
    sph_attr = jnp.concatenate(
        [
            packed.sph_colour.T[:, :3],
            packed.sph_origin.T,
            irad,
            jnp.ones((sp, 1), jnp.float32),
        ],
        axis=1,
    )
    return tri_attr, sph_attr


def _prep_affine_coefs(packed, camera: Camera):
    """Per-primitive affine/quadratic coefficients for shared-dir cameras.

    With direction d fixed and origin(x, y) = o0 + x*dox + y*doy:
      triangle (Möller–Trumbore): pvec, det, inv_det are per-triangle
      constants, and u, v, t are affine in (x, y);
      sphere: tca is affine, d^2 = |L|^2 - tca^2 is quadratic in (x, y).
    Returns tri_coef (9, Tp) rows [u0,ux,uy, v0,vx,vy, t0,tx,ty] and
    sph_coef (10, Sp) rows [tca0,tcax,tcay, d20,d2x,d2y,d2xx,d2yy,d2xy, r2].
    det-validity and zero-padding fold into u0 = -1e9 (never valid).
    """
    d = camera.d0
    o0, dox, doy = camera.o0, camera.dox, camera.doy

    v0 = packed.tri_v0.T  # (Tp, 3)
    e1 = packed.tri_e1.T
    e2 = packed.tri_e2.T
    pvec = jnp.cross(jnp.broadcast_to(d, e2.shape), e2)
    det = jnp.sum(e1 * pvec, -1)
    det_ok = jnp.abs(det) >= EPSILON
    inv = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    base = o0 - v0  # (Tp, 3)
    u0 = jnp.sum(base * pvec, -1) * inv
    ux = jnp.sum(dox * pvec, -1) * inv
    uy = jnp.sum(doy * pvec, -1) * inv
    q0 = jnp.cross(base, e1)
    qx = jnp.cross(jnp.broadcast_to(dox, e1.shape), e1)
    qy = jnp.cross(jnp.broadcast_to(doy, e1.shape), e1)
    v0c = jnp.sum(d * q0, -1) * inv
    vx = jnp.sum(d * qx, -1) * inv
    vy = jnp.sum(d * qy, -1) * inv
    t0c = jnp.sum(e2 * q0, -1) * inv
    tx = jnp.sum(e2 * qx, -1) * inv
    ty = jnp.sum(e2 * qy, -1) * inv
    u0 = jnp.where(det_ok, u0, -1e9)
    tri_coef = jnp.stack([u0, ux, uy, v0c, vx, vy, t0c, tx, ty], 0)

    C = packed.sph_origin.T  # (Sp, 3)
    r = packed.sph_radius[0]
    sp = C.shape[0]
    a = jnp.sum(dox * d)  # scalars
    b = jnp.sum(doy * d)
    L0 = C - o0
    tca0 = jnp.sum(L0 * d, -1)
    m0 = jnp.sum(L0 * L0, -1)
    mx = -2.0 * jnp.sum(L0 * dox, -1)
    my = -2.0 * jnp.sum(L0 * doy, -1)
    mxx = jnp.sum(dox * dox)
    myy = jnp.sum(doy * doy)
    mxy = 2.0 * jnp.sum(dox * doy)
    # d2 = m - tca^2 with tca = tca0 - a*x - b*y
    d20 = m0 - tca0 * tca0
    d2x = mx + 2.0 * tca0 * a
    d2y = my + 2.0 * tca0 * b
    d2xx = jnp.broadcast_to(mxx - a * a, (sp,))
    d2yy = jnp.broadcast_to(myy - b * b, (sp,))
    d2xy = jnp.broadcast_to(mxy - 2.0 * a * b, (sp,))
    sph_coef = jnp.stack(
        [
            tca0,
            jnp.broadcast_to(-a, (sp,)),
            jnp.broadcast_to(-b, (sp,)),
            d20, d2x, d2y, d2xx, d2yy, d2xy,
            r * r,
        ],
        0,
    )
    return tri_coef, sph_coef


def _safe_norm_rows(v):
    """Row norms with ZERO gradient at exactly-zero rows (padded prims).
    jnp.linalg.norm / sqrt(max(x, eps)) both have inf/NaN derivatives at 0,
    which poison the padded lanes of scene-parameter gradients."""
    s2 = jnp.sum(v * v, axis=-1)
    pos = s2 > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, s2, 1.0)), 0.0)


def _safe_unit_rows(v):
    mag = _safe_norm_rows(v)[..., None]
    pos = mag > 0
    return jnp.where(pos, v / jnp.where(pos, mag, 1.0), 0.0)
