"""Tiled forward kernel with per-tile primitive culling (Pallas, Triton).

Covers BOTH camera families: shared-direction (legacy ortho — affine
coefficient fast path) and shared-origin pinhole (projective coefficient
path, see _prep_projective_coefs). The reference has neither camera
generality nor culling (rayTracer.cl:111-202 brute-forces every primitive
per pixel with one fixed direction). This kernel is the acceleration
structure the reference never had (SURVEY.md §2: "no BVH"), built as a
dense two-level grid rather than a pointer tree:

1. BINNING (XLA): a primitive can only cover a 64x128-pixel tile if its
   screen-space bbox overlaps the tile rect. A (tiles x prims) overlap
   matrix -> top-K compaction gives each tile a padded candidate list and a
   CANDIDATE COUNT; the intersection COEFFICIENTS (kernels/prep.py
   _prep_affine_coefs, or the projective ones below) and the primitive
   attribute rows are gathered into per-tile tables.
2. TRACE (Pallas through Triton): one program per (tile, block of
   BLOCK_ROWS image rows). A program reads its own tile's counts; an empty
   tile stores the background word and returns. Otherwise each pixel of
   the block walks the tile's candidates in a loop whose trip count is the
   candidate count — so a tile with no triangle candidates does no triangle
   work — reading each candidate's coefficients as scalars (one load per
   coefficient, shared by every pixel of the block). Nearest-hit keeps the
   winner's t and candidate index; the winner's colour and normal are then
   gathered exactly from the tile's attribute rows. Shadows and shading
   run in the same program, which writes one packed RGBA word per pixel
   (or three float channels).
3. OVERFLOW: if any tile has more than K candidates the whole frame falls
   back to the XLA renderer (models/xla_backend) via jax.lax.cond — never
   silently wrong.

Shadows: a point p is occluded by triangle T from point light L iff p lies
inside the LIGHT FRUSTUM of T — behind T's plane (far side from L) and
inside the three side planes through L and each edge. The four planes are
precomputed per (light, triangle) at binning time (16 floats = one table
row), and because hit points are p = (x + t*d0x, y + t*d0y, t*d0z) under
the shared-direction camera, each plane test is AFFINE in (x, y, t): 3 FMA
+ compare. No Möller–Trumbore, no divides, no per-pixel shadow-ray setup.
Sphere occlusion keeps the geometric segment test. Shadow candidates are
binned per (light, tile) against the tile->light segment hull.
"""

from __future__ import annotations

import dataclasses as _dc
import functools
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from opencl_ray_tracer.camera import Camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.kernels.prep import (
    _LIGHT_STRIDE,
    _P_AMBIENT,
    _P_D0,
    _P_DDX,
    _P_DDY,
    _P_LIGHTS,
    _P_O0,
    _P_SHINE,
    _P_SPEC,
    _camera_params,
    _prep_affine_coefs,
    _prim_attrs,
    _round_up,
)
from opencl_ray_tracer.ops.intersect import EPSILON, MISS_T
from opencl_ray_tracer.ops.shading import (
    ALPHA_BITS,
    LEGACY_FOG_MAX,
    pack_framebuffer_words,
)
from opencl_ray_tracer.runtime.backend import check_kernel_platform

TILE_H = 64
TILE_W = 128
CHUNK = 8                        # candidate tables hold a multiple of this
# One program shades a (BLOCK_ROWS, TILE_W) block of pixels: 512 pixels on
# NUM_WARPS warps is 4 pixels per thread, so every scalar coefficient load
# is shared by 4 pixels and the per-pixel state (t, winner index,
# visibility, shading terms) stays in registers. Chosen on the H100 among
# (rows, warps) in {(2, 4), (4, 4), (8, 4), (8, 8), (16, 8)} through
# bench.py's harness: fastest at the stress scene, second at the headline
# (PERF.md).
BLOCK_ROWS = 4
N_SUB = TILE_H // BLOCK_ROWS     # programs per tile
NUM_WARPS = 4

# Shadow epsilons: the CPU oracle offsets the shadow origin 1e-2 along the
# normal and requires t > 1e-3 (ops/shading.py). The frustum test's
# equivalent is a distance margin on the (normalised) occluder-plane test;
# side planes use exact >= 0.
_SH_PLANE_EPS = 1e-2


# ---------------------------------------------------------------------------
# Binning (XLA)
# ---------------------------------------------------------------------------

def _prim_bboxes(packed):
    """Screen-space (x0, x1, y0, y1) per triangle / sphere (ortho camera)."""
    v0 = packed.tri_v0  # (3, Tp)
    v1 = packed.tri_v0 + packed.tri_e1
    v2 = packed.tri_v0 + packed.tri_e2
    txs = jnp.stack([v0[0], v1[0], v2[0]])
    tys = jnp.stack([v0[1], v1[1], v2[1]])
    tri_box = (
        jnp.min(txs, 0) - 1e-3, jnp.max(txs, 0) + 1e-3,
        jnp.min(tys, 0) - 1e-3, jnp.max(tys, 0) + 1e-3,
    )
    c = packed.sph_origin  # (3, Sp)
    r = packed.sph_radius[0] + 1e-3
    sph_box = (c[0] - r, c[0] + r, c[1] - r, c[1] + r)
    return tri_box, sph_box


def _prim_z_extents(packed, pad):
    """World-z AABB extents (z0, z1) per triangle / sphere, padded — the
    occluder z inputs of the segment-hull shadow culling."""
    v0 = packed.tri_v0
    v1 = packed.tri_v0 + packed.tri_e1
    v2 = packed.tri_v0 + packed.tri_e2
    tzs = jnp.stack([v0[2], v1[2], v2[2]])
    tri_z = (jnp.min(tzs, 0) - pad, jnp.max(tzs, 0) + pad)
    r = packed.sph_radius[0] + pad
    sph_z = (packed.sph_origin[2] - r, packed.sph_origin[2] + r)
    return tri_z, sph_z


def _tile_hit_z(t_idx, t_valid, s_idx, s_valid, tri_zext, sph_zext,
                nty, ntx):
    """PER-TILE z range hit points can occupy: the min/max of the (padded)
    z extents over the tile's PRIMARY candidate primitives — hits lie on
    candidate surfaces, and the soft path's softmin t is a convex
    combination of per-candidate hits, so the combined z stays inside the
    candidates' hull. Feeding this as the segment-hull tile_z (instead of
    the global scene slab) kills occluders that sit between the light and
    SOME part of the scene but not this tile's hits. Tiles with no primary
    candidates get an inverted slab; their shadow lists are garbage-but-
    unread (the kernels skip primary-empty tiles entirely). Safe under
    primary overflow: overflow falls back to the XLA renderer for the
    frame, so truncated candidate lists never feed a used bound.
    Returns (tz0, tz1) shaped (nty, ntx, 1) for _bin_prims broadcasting."""
    big = jnp.float32(1e30)

    def rng(idx, valid, zext):
        z0 = jnp.where(valid, zext[0][idx], big)
        z1 = jnp.where(valid, zext[1][idx], -big)
        return jnp.min(z0, axis=1), jnp.max(z1, axis=1)

    t0, t1 = rng(t_idx, t_valid, tri_zext)
    s0, s1 = rng(s_idx, s_valid, sph_zext)
    tz0 = jnp.minimum(t0, s0).reshape(nty, ntx, 1)
    tz1 = jnp.maximum(t1, s1).reshape(nty, ntx, 1)
    return tz0, tz1


def _pinhole_bboxes(packed, camera: Camera):
    """Screen-space conservative bboxes under a shared-origin pinhole camera.

    Pixel (x, y) traces direction d0 + x*ddx + y*ddy from origin o, so a
    world point P projects to [x*k, y*k, k] = M^-1 (P - o) with
    M = [ddx | ddy | d0] columns. A convex primitive's screen bbox is the
    bbox of its projected corner points (central projection preserves convex
    hulls in front of the camera); any corner at or behind the near plane
    makes the bbox conservatively cover the whole screen — correct, just
    uncullable for that primitive.
    """
    M = jnp.stack([camera.ddx, camera.ddy, camera.d0], axis=1)
    Minv = jnp.linalg.inv(M)
    big = 1e9

    def box(P):  # (N, K, 3) corner points per primitive
        v = jnp.einsum("ij,nkj->nki", Minv, P - camera.o0)
        w = v[..., 2]
        front = w > 1e-6
        ok = jnp.all(front, axis=1)
        sw = jnp.where(front, w, 1.0)
        sx = v[..., 0] / sw
        sy = v[..., 1] / sw
        pad = 1.0  # half-pixel centre offset + f32 slack
        return (
            jnp.where(ok, jnp.min(sx, 1) - pad, -big),
            jnp.where(ok, jnp.max(sx, 1) + pad, big),
            jnp.where(ok, jnp.min(sy, 1) - pad, -big),
            jnp.where(ok, jnp.max(sy, 1) + pad, big),
        )

    v0 = packed.tri_v0.T  # (Tp, 3)
    tri_box = box(
        jnp.stack([v0, v0 + packed.tri_e1.T, v0 + packed.tri_e2.T], axis=1)
    )
    c = packed.sph_origin.T  # (Sp, 3)
    r = packed.sph_radius[0]
    signs = jnp.array(
        [
            [sx, sy, sz]
            for sx in (-1.0, 1.0)
            for sy in (-1.0, 1.0)
            for sz in (-1.0, 1.0)
        ],
        jnp.float32,
    )  # (8, 3) AABB corner pattern
    sph_box = box(c[:, None, :] + r[:, None, None] * signs[None])
    return tri_box, sph_box


def _prep_projective_coefs(packed, camera: Camera):
    """Per-primitive projective coefficients for shared-ORIGIN (pinhole)
    cameras — the perspective analogue of prep._prep_affine_coefs.

    With origin o fixed and UNNORMALIZED direction d(x, y) = d0 + x*ddx +
    y*ddy, Möller–Trumbore is projective in pixel coords:

        pvec  = d x e2                    affine in (x, y)   (cross linear in d)
        det   = e1 . pvec                 affine
        u_num = (o - v0) . pvec           affine
        qvec  = (o - v0) x e1             constant per triangle
        v_num = d . qvec                  affine
        t_num = e2 . qvec                 constant

    u = u_num/det, v = v_num/det and the WORLD distance along the unit
    direction is t = (t_num/det) * |d|. The kernel evaluates validity
    sign-aware (multiply through by sign(det)) so the inner loop stays
    FMA + compares with a single divide for t. Sphere (geometric, reference
    quirks preserved): L = c - o is constant per sphere, tca = (L . d)/|d|,
    d^2 = |L|^2 - tca^2.

    Returns tri_coef (10, Tp) rows [det0,detx,dety, un0,unx,uny,
    vn0,vnx,vny, tnum]; sph_coef (5, Sp) rows [tc0,tcx,tcy, L2, r2].
    Zero-padded triangles give det == 0 everywhere and fail the kernel's
    |det| >= eps*|d| test. Pure jnp, differentiable.
    """
    o0, d0, ddx, ddy = camera.o0, camera.d0, camera.ddx, camera.ddy

    v0 = packed.tri_v0.T  # (Tp, 3)
    e1 = packed.tri_e1.T
    e2 = packed.tri_e2.T
    pv0 = jnp.cross(jnp.broadcast_to(d0, e2.shape), e2)
    pvx = jnp.cross(jnp.broadcast_to(ddx, e2.shape), e2)
    pvy = jnp.cross(jnp.broadcast_to(ddy, e2.shape), e2)
    det0 = jnp.sum(e1 * pv0, -1)
    detx = jnp.sum(e1 * pvx, -1)
    dety = jnp.sum(e1 * pvy, -1)
    base = o0 - v0
    un0 = jnp.sum(base * pv0, -1)
    unx = jnp.sum(base * pvx, -1)
    uny = jnp.sum(base * pvy, -1)
    q = jnp.cross(base, e1)
    vn0 = jnp.sum(d0 * q, -1)
    vnx = jnp.sum(ddx * q, -1)
    vny = jnp.sum(ddy * q, -1)
    tnum = jnp.sum(e2 * q, -1)
    tri_coef = jnp.stack(
        [det0, detx, dety, un0, unx, uny, vn0, vnx, vny, tnum], 0
    )

    C = packed.sph_origin.T  # (Sp, 3)
    r = packed.sph_radius[0]
    L = C - o0
    tc0 = jnp.sum(L * d0, -1)
    tcx = jnp.sum(L * ddx, -1)
    tcy = jnp.sum(L * ddy, -1)
    l2 = jnp.sum(L * L, -1)
    sph_coef = jnp.stack([tc0, tcx, tcy, l2, r * r], 0)
    return tri_coef, sph_coef


def _axis_s_interval(b0, b1, L, o0, o1):
    """Feasible s-interval for one axis of the segment-hull test.

    Points reachable by shadow segments are (1-s)*p + s*L, p in the tile's
    hit box B, s in [0, 1]. Per axis, the occluder interval [o0, o1] is
    reachable iff (1-s)*b0 + s*L <= o1 AND (1-s)*b1 + s*L >= o0 — two
    linear inequalities in s. Returns (lo, hi, ok): feasible s in [lo, hi]
    when ok (ok=False encodes an unconditionally-empty degenerate axis)."""
    eps = 1e-12
    big = jnp.float32(1e30)
    dA = L - b0
    rA = o1 - b0
    hiA = jnp.where(dA > eps, rA / jnp.where(dA > eps, dA, 1.0), big)
    loA = jnp.where(dA < -eps, rA / jnp.where(dA < -eps, dA, 1.0), -big)
    okA = jnp.where(jnp.abs(dA) <= eps, rA >= 0, True)
    dB = L - b1
    rB = o0 - b1
    loB = jnp.where(dB > eps, rB / jnp.where(dB > eps, dB, 1.0), -big)
    hiB = jnp.where(dB < -eps, rB / jnp.where(dB < -eps, dB, 1.0), big)
    okB = jnp.where(jnp.abs(dB) <= eps, rB <= 0, True)
    return jnp.maximum(loA, loB), jnp.minimum(hiA, hiB), okA & okB


def _bin_prims(box, n_real, nty, ntx, k, light_xy=None, offs=None,
               light_z=None, prim_z=None, tile_z=None):
    """(tiles x prims) overlap -> per-tile top-k candidate indices.

    With light_xy=(lx, ly), tiles are expanded to the bbox of the
    tile->light corridor: an occluder can only shadow a tile's hit points
    (which sit in the tile's xy column under the shared -z direction) if its
    xy-bbox overlaps bbox(tile_rect ∪ light_xy) — the conservative
    shadow-candidate test.

    With light_z + prim_z=(pz0, pz1) per prim + tile_z=(tz0, tz1) (the z
    range hit points can occupy — scalars or per-tile (nty, ntx, 1)
    arrays, see _tile_hit_z), the corridor tightens
    to the SEGMENT-HULL test: the occluder AABB must intersect the convex
    hull of (tile hit box x light point). Per axis the feasible segment
    parameter s is an interval (_axis_s_interval); a prim is a candidate iff
    the three intervals and [0, 1] intersect. This kills the corridor's
    biggest false positives — slab-bound occluders midway to an elevated
    light sit BELOW every actual shadow segment there.

    offs=(x_off, y_off) shifts the tile rects into WORLD coordinates for
    shifted ortho cameras (the shard_map camera-shift trick: shard i's local
    pixel row 0 is world row o0.y).

    Returns idx (n_tiles, k) int32, valid (n_tiles, k) bool,
    count (n_tiles,) int32 (clamped to k), overflow ()."""
    x0, x1, y0, y1 = box
    p = x0.shape[0]
    x_off, y_off = offs if offs is not None else (0.0, 0.0)
    tx0 = (jnp.arange(ntx, dtype=jnp.float32) * TILE_W)[None, :, None] + x_off
    ty0 = (jnp.arange(nty, dtype=jnp.float32) * TILE_H)[:, None, None] + y_off
    tx1 = tx0 + TILE_W
    ty1 = ty0 + TILE_H
    # padded prims beyond n_real never overlap (their bbox is degenerate far
    # away for spheres / all-zero for tris, but mask explicitly anyway)
    real = jnp.arange(p) < n_real
    if (
        light_xy is not None
        and light_z is not None
        and prim_z is not None
        and tile_z is not None
    ):
        lx, ly = light_xy
        pz0, pz1 = prim_z
        tz0, tz1 = tile_z
        sx0, sx1, okx = _axis_s_interval(
            tx0, tx1, lx, x0[None, None, :], x1[None, None, :]
        )
        sy0, sy1, oky = _axis_s_interval(
            ty0, ty1, ly, y0[None, None, :], y1[None, None, :]
        )
        sz0, sz1, okz = _axis_s_interval(
            tz0, tz1, light_z, pz0[None, None, :], pz1[None, None, :]
        )
        lo = jnp.maximum(jnp.maximum(sx0, sy0), jnp.maximum(sz0, 0.0))
        hi = jnp.minimum(jnp.minimum(sx1, sy1), jnp.minimum(sz1, 1.0))
        overlap = (
            (lo <= hi) & okx & oky & okz & real[None, None, :]
        ).reshape(nty * ntx, p)
    else:
        if light_xy is not None:
            lx, ly = light_xy
            tx0 = jnp.minimum(tx0, lx)
            tx1 = jnp.maximum(tx1, lx)
            ty0 = jnp.minimum(ty0, ly)
            ty1 = jnp.maximum(ty1, ly)
        overlap = (
            (x0[None, None, :] <= tx1)
            & (x1[None, None, :] >= tx0)
            & (y0[None, None, :] <= ty1)
            & (y1[None, None, :] >= ty0)
            & real[None, None, :]
        ).reshape(nty * ntx, p)
    counts = jnp.sum(overlap, axis=1, dtype=jnp.int32)
    overflow = jnp.max(counts) > k
    # top-k by (overlap, ascending index): score = P - i for overlapping.
    # k may exceed the padded primitive count (chunk-granularity rounding);
    # top_k runs at min(k, p) and the tail columns pad invalid.
    ktop = min(k, p)
    score = jnp.where(overlap, p - jnp.arange(p, dtype=jnp.int32), 0)
    top, _ = jax.lax.top_k(score, ktop)       # (n_tiles, ktop), descending
    valid = top > 0
    idx = jnp.where(valid, p - top, 0)
    if ktop < k:
        idx = jnp.pad(idx, ((0, 0), (0, k - ktop)))
        valid = jnp.pad(valid, ((0, 0), (0, k - ktop)))
    return idx, valid, jnp.minimum(counts, k), overflow


# null coefficient columns: guarantee "never valid" in the kernel tests.
_NULL_TRI = np.array(
    [-1e9, 0, 0, -1e9, 0, 0, 0, 0, 0], np.float32
)  # u0 = v0 = -1e9
_NULL_SPH = np.array(
    [-1e9, 0, 0, 1e9, 0, 0, 0, 0, 0, -1.0], np.float32
)  # tca < 0 and r2 < 0 and d2 huge
# projective nulls: det == 0 fails |det| >= eps*|d|; tca < 0 fails tca >= 0.
_NULL_TRI_PROJ = np.zeros((10,), np.float32)
_NULL_SPH_PROJ = np.array([-1e9, 0, 0, 0, -1.0], np.float32)


def _tri_shadow_planes(packed, lpos):
    """Light-frustum planes per triangle for point light `lpos` (3,).

    Row layout (16 floats): [m0(3) c0  m1(3) c1  m2(3) c2  n(3) cp] where a
    point p is occluded iff  mi.p + ci >= 0 for the three (normalised) side
    planes through the light and each edge, and n.p + cp >= eps for the
    (normalised) triangle plane oriented away from the light. Degenerate
    triangles / light-in-plane rows are disabled via c = -1e9."""
    v0 = packed.tri_v0.T            # (Tp, 3)
    e1 = packed.tri_e1.T
    e2 = packed.tri_e2.T
    v1 = v0 + e1
    v2 = v0 + e2
    L = lpos[None, :]

    def _norm_rows(m):
        n = jnp.linalg.norm(m, axis=-1, keepdims=True)
        return m / jnp.maximum(n, 1e-20), n[..., 0]

    def side(vi, vj, vk):
        m = jnp.cross(vj - vi, L - vi)
        m, mag = _norm_rows(m)
        s_k = jnp.sum(m * (vk - vi), -1)
        m = m * jnp.where(s_k < 0, -1.0, 1.0)[:, None]
        c = -jnp.sum(m * vi, -1)
        degen = (jnp.abs(s_k) < 1e-9) | (mag < 1e-12)
        c = jnp.where(degen, -1e9, c)
        return m, c

    m0, c0 = side(v0, v1, v2)
    m1, c1 = side(v1, v2, v0)
    m2, c2 = side(v2, v0, v1)
    n = jnp.cross(e1, e2)
    n, nmag = _norm_rows(n)
    s_l = jnp.sum(n * (L - v0), -1)
    n = n * jnp.where(s_l > 0, -1.0, 1.0)[:, None]
    cp = -jnp.sum(n * v0, -1)
    degen = (jnp.abs(s_l) < 1e-9) | (nmag < 1e-12)
    cp = jnp.where(degen, -1e9, cp)
    return jnp.concatenate(
        [
            m0, c0[:, None], m1, c1[:, None],
            m2, c2[:, None], n, cp[:, None],
        ],
        axis=1,
    )  # (Tp, 16)


def _sph_shadow_rows(packed):
    """Sphere occluder rows: [cx, cy, cz, r2, 0...] (padded: r2=0, far z)."""
    sp = packed.padded_spheres
    rows = jnp.zeros((sp, 16), jnp.float32)
    rows = rows.at[:, 0:3].set(packed.sph_origin.T)
    rows = rows.at[:, 3].set(packed.sph_radius[0] ** 2)
    return rows


# null shadow rows: tri planes all fail (c = -1e9); spheres at z=+1e9, r2=0.
_NULL_SH_TRI = np.array(
    [0, 0, 0, -1e9, 0, 0, 0, -1e9, 0, 0, 0, -1e9, 0, 0, 0, -1e9], np.float32
)
_NULL_SH_SPH = np.array(
    [0, 0, 1e9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32
)


def _shadow_tables(rows_per_light, box, n_real, nty, ntx, k, lights_pos,
                   null_row, offs=None, prim_z=None, tile_z=None):
    """Per-(light, tile) shadow-candidate tables, flattened to 3-D
    (n_tiles, L*k, 16) — light li owns candidate rows [li*k, (li+1)*k).

    rows_per_light: callable li -> (P, 16) candidate rows for that light.
    prim_z/tile_z enable the segment-hull z tightening (see _bin_prims).
    Returns (tables, counts (n_tiles, L) int32, overflow)."""
    tabs, cnts = [], []
    overflow = jnp.zeros((), bool)
    for li in range(lights_pos.shape[0]):
        idx, valid, count, over = _bin_prims(
            box, n_real, nty, ntx, k,
            light_xy=(lights_pos[li, 0], lights_pos[li, 1]), offs=offs,
            light_z=lights_pos[li, 2], prim_z=prim_z, tile_z=tile_z,
        )
        g = rows_per_light(li)[idx]                    # (n_tiles, k, 16)
        g = jnp.where(valid[..., None], g, null_row)
        tabs.append(g)
        cnts.append(count)
        overflow |= over
    return jnp.concatenate(tabs, axis=1), jnp.stack(cnts, axis=1), overflow


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _build_kernel(
    *,
    ntx: int,
    n_lights: int,
    shading: str,
    shadows: bool,
    projective: bool,
    out_packed: bool,
):
    R, W = BLOCK_ROWS, TILE_W
    f32 = jnp.float32

    def kernel(params_ref, counts_ref, tc_ref, ta_ref, sc_ref, sa_ref,
               tsh_ref, ssh_ref, *out_refs):
        tile = pl.program_id(0)
        sub = pl.program_id(1)
        cnt_tri = counts_ref[tile, 0]
        cnt_sph = counts_ref[tile, 1]
        empty = (cnt_tri + cnt_sph) == 0

        # No primary candidate: every pixel of the tile misses, so the
        # whole pipeline would write rgb = 0, alpha = 255.
        @pl.when(empty)
        def _():
            if out_packed:
                out_refs[0][...] = jnp.full((R, W), ALPHA_BITS, jnp.int32)
            else:
                for ref in out_refs:
                    ref[...] = jnp.zeros((R, W), f32)

        @pl.when(jnp.logical_not(empty))
        def _():
            r, g, b = trace(tile, sub, cnt_tri, cnt_sph, params_ref,
                            counts_ref, tc_ref, ta_ref, sc_ref, sa_ref,
                            tsh_ref, ssh_ref)
            if out_packed:
                # clamp to the byte range (utils/image.pack_rgba), truncate
                # like the reference's int cast (rayTracer.cl:193-196) and
                # pack R | G<<8 | B<<16 | 255<<24 into one int32 per pixel
                ri, gi, bi = (
                    jnp.clip(c, 0.0, 255.0).astype(jnp.int32) for c in (r, g, b)
                )
                out_refs[0][...] = (
                    ri + gi * 256 + bi * 65536 + jnp.int32(ALPHA_BITS)
                )
            else:
                for ref, c in zip(out_refs, (r, g, b)):
                    ref[...] = c

    def trace(tile, sub, cnt_tri, cnt_sph, params_ref, counts_ref, tc_ref,
              ta_ref, sc_ref, sa_ref, tsh_ref, ssh_ref):
        p = lambda q: params_ref[q]
        ty = tile // ntx
        tx = tile - ty * ntx
        col = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
        row = jax.lax.broadcasted_iota(jnp.int32, (R, W), 0)
        x = (tx * W + col).astype(f32)
        y = (ty * TILE_H + sub * R + row).astype(f32)
        o0 = tuple(p(_P_O0 + q) for q in range(3))
        d0 = tuple(p(_P_D0 + q) for q in range(3))
        if projective:
            ddx = tuple(p(_P_DDX + q) for q in range(3))
            ddy = tuple(p(_P_DDY + q) for q in range(3))
            # per-pixel unnormalized direction and its length, shared by
            # every candidate test
            du = tuple(d0[q] + x * ddx[q] + y * ddy[q] for q in range(3))
            len2 = jnp.maximum(du[0] * du[0] + du[1] * du[1] + du[2] * du[2],
                               1e-20)
            inv_len = jax.lax.rsqrt(len2)
            len_d = len2 * inv_len

        def tri_test(i):
            c = lambda q: tc_ref[tile, i, q]
            if projective:
                det = c(0) + x * c(1) + y * c(2)
                un = c(3) + x * c(4) + y * c(5)
                vn = c(6) + x * c(7) + y * c(8)
                # sign-aware barycentric tests without dividing; |det| >=
                # eps*|d| matches the oracle's normalized-direction eps
                sgn = jnp.where(det >= 0.0, 1.0, -1.0)
                dets, uns, vns = det * sgn, un * sgn, vn * sgn
                valid = ((dets >= EPSILON * len_d) & (uns >= 0.0)
                         & (vns >= 0.0) & (uns + vns <= dets))
                return c(9) / jnp.where(valid, det, 1.0) * len_d, valid
            u = c(0) + x * c(1) + y * c(2)
            v = c(3) + x * c(4) + y * c(5)
            t = c(6) + x * c(7) + y * c(8)
            return t, (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)

        def sph_test(i):
            c = lambda q: sc_ref[tile, i, q]
            if projective:
                tca = (c(0) + x * c(1) + y * c(2)) * inv_len
                d2 = c(3) - tca * tca
                r2 = c(4)
            else:
                tca = c(0) + x * c(1) + y * c(2)
                d2 = (c(3) + x * c(4) + y * c(5) + x * x * c(6)
                      + y * y * c(7) + x * y * c(8))
                r2 = c(9)
            hit = (tca >= 0.0) & (d2 <= r2)
            t0 = tca - jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
            return t0, hit & (t0 != 0.0)

        def nearest(test, count, offset, carry):
            # Strict < keeps the earlier candidate on ties — the reference's
            # first-in-order tie break (rayTracer.cl:140-184); candidates
            # are in primitive order, triangles before spheres.
            def body(i, carry):
                bt, bi = carry
                t, valid = test(i)
                win = valid & (t < bt)
                return jnp.where(win, t, bt), jnp.where(win, i + offset, bi)

            return jax.lax.fori_loop(0, count, body, carry)

        kt = tc_ref.shape[1]
        best = (jnp.full((R, W), MISS_T, f32), jnp.full((R, W), -1, jnp.int32))
        best = nearest(tri_test, cnt_tri, 0, best)
        bt, bi = nearest(sph_test, cnt_sph, kt, best)
        hit = bt < MISS_T

        # exact attribute gather of the winner (index kt.. = spheres)
        is_tri = bi < kt
        ti = jnp.clip(bi, 0, kt - 1)
        si = jnp.clip(bi - kt, 0, sa_ref.shape[1] - 1)

        def attr(q):
            return jnp.where(is_tri, ta_ref[tile, ti, q], sa_ref[tile, si, q])

        cr, cg, cb = attr(0), attr(1), attr(2)
        if shading == "legacy":
            s = 255.0 - bt * (255.0 / LEGACY_FOG_MAX)
            return tuple(jnp.where(hit, c * s, 0.0) for c in (cr, cg, cb))

        if projective:
            rd = tuple(c * inv_len for c in du)          # unit ray direction
            pt = tuple(o0[q] + bt * rd[q] for q in range(3))
            view = tuple(-c for c in rd)
        else:
            # origin o0 + (x, y, 0) + t*d (o0 is the row-shard shift under
            # sharded cameras; zero for the base camera)
            rd = d0
            pt = (o0[0] + x + bt * d0[0], o0[1] + y + bt * d0[1],
                  o0[2] + bt * d0[2])
            vinv = jax.lax.rsqrt(
                jnp.maximum(d0[0] * d0[0] + d0[1] * d0[1] + d0[2] * d0[2],
                            1e-20)
            )
            view = tuple(-c * vinv for c in d0)

        lights = []
        for li in range(n_lights):
            base = _P_LIGHTS + li * _LIGHT_STRIDE
            lp = tuple(p(base + q) for q in range(3))
            tl = tuple(lp[q] - pt[q] for q in range(3))
            tl2 = jnp.maximum(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2],
                              1e-20)
            rinv = jax.lax.rsqrt(tl2)
            ld = tuple(c * rinv for c in tl)
            vis = (occlusion(tile, li, counts_ref, tsh_ref, ssh_ref, x, y, bt,
                             o0, rd, pt, ld, tl2 * rinv)
                   if shadows else 1.0)
            lc = tuple(p(base + 3 + q) for q in range(3))
            lights.append((ld, lc, p(base + 6), vis))

        ax, ay, az, irad, is_sph = (attr(q) for q in range(3, 8))
        flip = jnp.where(ax * rd[0] + ay * rd[1] + az * rd[2] > 0, -1.0, 1.0)
        sph = is_sph > 0.5
        nx = jnp.where(sph, (pt[0] - ax) * irad, ax * flip)
        ny = jnp.where(sph, (pt[1] - ay) * irad, ay * flip)
        nz = jnp.where(sph, (pt[2] - az) * irad, az * flip)
        ninv = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv

        ambient, spec_k, shine = p(_P_AMBIENT), p(_P_SPEC), p(_P_SHINE)
        diff = [0.0, 0.0, 0.0]
        spec = [0.0, 0.0, 0.0]
        for ld, lc, lint, vis in lights:
            ndl = nx * ld[0] + ny * ld[1] + nz * ld[2]
            ndotl = jnp.maximum(ndl, 0.0)
            wdiff = lint * ndotl * vis
            for q in range(3):
                diff[q] = diff[q] + wdiff * lc[q]
            if shading == "phong":
                two_ndl = 2.0 * ndl
                rx = two_ndl * nx - ld[0]
                ry = two_ndl * ny - ld[1]
                rz = two_ndl * nz - ld[2]
                rdotv = jnp.maximum(rx * view[0] + ry * view[1] + rz * view[2],
                                    0.0)
                wspec = (spec_k * jnp.exp(shine * jnp.log(jnp.maximum(rdotv, 1e-20)))
                         * lint * vis * (ndotl > 0.0))
                for q in range(3):
                    spec[q] = spec[q] + wspec * lc[q]
        return tuple(
            jnp.where(hit,
                      jnp.clip(c * (ambient + diff[q]) + spec[q], 0.0, 1.0)
                      * 255.0,
                      0.0)
            for q, c in enumerate((cr, cg, cb))
        )

    def occlusion(tile, li, counts_ref, tsh_ref, ssh_ref, x, y, t, o0, rd,
                  pt, ld, dist):
        """Visibility (1 or 0) of light li from the hit points."""
        sh_tile = 0 if projective else tile   # pinhole tables are shared
        k_sh_tri = tsh_ref.shape[1] // n_lights
        k_sh_sph = ssh_ref.shape[1] // n_lights
        # m.o0 + c folds into one scalar per plane
        def tri_body(i, vis):
            c = lambda q: tsh_ref[sh_tile, li * k_sh_tri + i, q]
            blocked = None
            for pi in range(4):
                mx, my, mz, cc = (c(4 * pi + q) for q in range(4))
                off = cc + mx * o0[0] + my * o0[1] + mz * o0[2]
                if projective:   # p = o + t*dn
                    s = off + (mx * rd[0] + my * rd[1] + mz * rd[2]) * t
                else:            # p = o0 + (x, y, 0) + t*d0
                    s = (off + mx * x + my * y
                         + (mx * rd[0] + my * rd[1] + mz * rd[2]) * t)
                cond = s >= (_SH_PLANE_EPS if pi == 3 else 0.0)
                blocked = cond if blocked is None else (blocked & cond)
            return jnp.where(blocked, 0.0, vis)

        def sph_body(i, vis):
            c = lambda q: ssh_ref[sh_tile, li * k_sh_sph + i, q]
            lx, ly, lz = c(0) - pt[0], c(1) - pt[1], c(2) - pt[2]
            r2 = c(3)
            tca = lx * ld[0] + ly * ld[1] + lz * ld[2]
            m2 = lx * lx + ly * ly + lz * lz - tca * tca
            t0 = tca - jnp.sqrt(jnp.maximum(r2 - m2, 0.0))
            blocked = ((tca >= 0.0) & (m2 <= r2) & (t0 > 1e-3)
                       & (t0 < dist))
            return jnp.where(blocked, 0.0, vis)

        vis = jnp.ones((R, W), f32)
        vis = jax.lax.fori_loop(0, counts_ref[tile, 2 + 2 * li], tri_body, vis)
        return jax.lax.fori_loop(0, counts_ref[tile, 3 + 2 * li], sph_body,
                                 vis)

    return kernel


# ---------------------------------------------------------------------------
# Binning products + wrapper
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@_dc.dataclass
class TileBins:
    """Scene-static binning products, reusable across frames/cameras.

    Everything here depends only on the scene (and light xy for shadow
    tables) — NOT on the camera. For animation/optimization loops, compute
    once per scene with `bin_scene` and pass to render; the per-frame work
    is then just the (camera-dependent) affine-coefficient gather + kernel.
    """

    t_idx: jax.Array       # (n_tiles, k_tri) int32
    t_valid: jax.Array     # (n_tiles, k_tri) bool
    s_idx: jax.Array       # (n_tiles, k_sph)
    s_valid: jax.Array
    tri_attr_t: jax.Array  # (n_tiles, k_tri, 8)
    sph_attr_t: jax.Array  # (n_tiles, k_sph, 8)
    tri_sh_t: jax.Array    # (n_tiles | 1, L*k_sh_tri, 16) frustum planes
    sph_sh_t: jax.Array    # (n_tiles | 1, L*k_sh_sph, 16) occluder rows
    counts: jax.Array      # (n_tiles, 2 + 2L) int32
    overflow: jax.Array    # () bool
    k_tri: int = _dc.field(metadata=dict(static=True), default=0)
    k_sph: int = _dc.field(metadata=dict(static=True), default=0)
    k_sh_tri: int = _dc.field(metadata=dict(static=True), default=0)
    k_sh_sph: int = _dc.field(metadata=dict(static=True), default=0)
    nty: int = _dc.field(metadata=dict(static=True), default=0)
    ntx: int = _dc.field(metadata=dict(static=True), default=0)
    # pinhole bins: perspective bboxes, shared full shadow tables. A
    # projective bins object only renders with a normalize camera (and
    # vice versa); _render_tiled_jit enforces the match.
    projective: bool = _dc.field(metadata=dict(static=True), default=False)


@functools.partial(
    jax.jit, static_argnames=("height", "width", "k", "shadows", "shadow_k")
)
def bin_scene(packed, *, height: int, width: int, k: int = 32,
              shadows: bool = False, shadow_k: int = 64,
              camera: Optional[Camera] = None) -> TileBins:
    """Tile binning (primary + shadow candidate lists).

    Without `camera` (or with a shared-direction one): scene-static ortho
    binning, reusable across frames/cameras. With a normalize (pinhole)
    `camera`: perspective screen-space bboxes — the bins then depend on the
    camera pose and must be recomputed when it moves.

    Shared-direction cameras contribute only their origin OFFSET (o0.xy):
    tile rects shift into world coordinates, which is what makes the
    shard_map camera-shift trick bin correctly per row shard. (The ortho
    binning assumes the legacy image-space convention dox = x, doy = y.)"""
    projective = camera is not None and camera.normalize
    offs = (
        (camera.o0[0], camera.o0[1])
        if (camera is not None and not projective) else None
    )
    nty = _round_up(height, TILE_H) // TILE_H
    ntx = _round_up(width, TILE_W) // TILE_W
    n_tiles = nty * ntx
    n_lights = packed.lights.position.shape[0]
    tri_attr, sph_attr = _prim_attrs(packed)
    if projective:
        tri_box, sph_box = _pinhole_bboxes(packed, camera)
    else:
        tri_box, sph_box = _prim_bboxes(packed)

    k_tri = (
        min(k, _round_up(max(packed.n_tris, 1), CHUNK)) if packed.n_tris else 0
    )
    k_sph = (
        min(k, _round_up(max(packed.n_spheres, 1), CHUNK))
        if packed.n_spheres else 0
    )

    overflow = jnp.zeros((), bool)
    zero_cnt = jnp.zeros((n_tiles,), jnp.int32)
    if k_tri:
        t_idx, t_valid, cnt_tri, over = _bin_prims(
            tri_box, packed.n_tris, nty, ntx, k_tri, offs=offs
        )
        overflow |= over
        tri_attr_t = jnp.where(t_valid[..., None], tri_attr[t_idx], 0.0)
    else:
        t_idx = jnp.zeros((n_tiles, CHUNK), jnp.int32)
        t_valid = jnp.zeros((n_tiles, CHUNK), bool)
        tri_attr_t = jnp.zeros((n_tiles, CHUNK, 8), jnp.float32)
        cnt_tri = zero_cnt
    if k_sph:
        s_idx, s_valid, cnt_sph, over = _bin_prims(
            sph_box, packed.n_spheres, nty, ntx, k_sph, offs=offs
        )
        overflow |= over
        sph_attr_t = jnp.where(s_valid[..., None], sph_attr[s_idx], 0.0)
    else:
        s_idx = jnp.zeros((n_tiles, CHUNK), jnp.int32)
        s_valid = jnp.zeros((n_tiles, CHUNK), bool)
        sph_attr_t = jnp.zeros((n_tiles, CHUNK, 8), jnp.float32)
        cnt_sph = zero_cnt

    # Shadow candidate tables. Ortho: per-(light, tile) corridor binning.
    # Pinhole: shadow rays fan out from hit points anywhere in the tile's
    # view frustum toward the light, so no screen-space corridor bounds the
    # occluder set (an occluder between surface and light need not be
    # visible in the tile at all). Shadow candidates are then the FULL
    # primitive set, stored ONCE and shared by every tile (the kernel
    # reads shadow tile 0). Primary-ray culling is unaffected;
    # the perf-critical legacy pinhole mode has no shadows.
    sh_tiles = 1 if projective else n_tiles
    if projective:
        k_sh_tri = packed.padded_tris if (shadows and packed.n_tris) else 0
        k_sh_sph = packed.padded_spheres if (shadows and packed.n_spheres) else 0
    else:
        k_sh_tri = (
            min(shadow_k, _round_up(packed.n_tris, CHUNK))
            if (shadows and packed.n_tris) else 0
        )
        k_sh_sph = (
            min(shadow_k, _round_up(packed.n_spheres, CHUNK))
            if (shadows and packed.n_spheres) else 0
        )
    lpos = packed.lights.position
    # z inputs of the segment-hull shadow culling (small pad: exact hard
    # occlusion plus the shadow-ray t_min offset margin). tile_z is the
    # PER-TILE hit-z slab from the primary candidate lists —
    # strictly tighter than the global scene slab it replaces.
    z_pad = 0.1
    tri_zext, sph_zext = _prim_z_extents(packed, z_pad)
    tile_z = _tile_hit_z(
        t_idx, t_valid, s_idx, s_valid, tri_zext, sph_zext, nty, ntx
    )
    if k_sh_tri:
        if projective:
            planes = jnp.stack(
                [_tri_shadow_planes(packed, lpos[li]) for li in range(n_lights)]
            )  # (L, Tp, 16); padded tris have degenerate rows (c = -1e9)
            tri_sh_t = planes.reshape(1, n_lights * k_sh_tri, 16)
            cnt_sh_tri = jnp.full((n_tiles, n_lights), packed.n_tris, jnp.int32)
        else:
            tri_sh_t, cnt_sh_tri, over = _shadow_tables(
                lambda li: _tri_shadow_planes(packed, lpos[li]),
                tri_box, packed.n_tris, nty, ntx, k_sh_tri, lpos, _NULL_SH_TRI,
                offs=offs, prim_z=tri_zext, tile_z=tile_z,
            )
            overflow |= over
    else:
        tri_sh_t = jnp.broadcast_to(
            _NULL_SH_TRI, (sh_tiles, n_lights * CHUNK, 16)
        )
        cnt_sh_tri = jnp.zeros((n_tiles, n_lights), jnp.int32)
    if k_sh_sph:
        sph_rows = _sph_shadow_rows(packed)
        if projective:
            # null the padded slots (zero-radius spheres at the origin could
            # false-occlude a ray passing exactly through it)
            real = jnp.arange(packed.padded_spheres) < packed.n_spheres
            sph_rows = jnp.where(real[:, None], sph_rows, _NULL_SH_SPH)
            sph_sh_t = jnp.broadcast_to(
                sph_rows, (n_lights, k_sh_sph, 16)
            ).reshape(1, n_lights * k_sh_sph, 16)
            cnt_sh_sph = jnp.full(
                (n_tiles, n_lights), packed.n_spheres, jnp.int32
            )
        else:
            sph_sh_t, cnt_sh_sph, over = _shadow_tables(
                lambda li: sph_rows,
                sph_box, packed.n_spheres, nty, ntx, k_sh_sph, lpos,
                _NULL_SH_SPH, offs=offs, prim_z=sph_zext, tile_z=tile_z,
            )
            overflow |= over
    else:
        sph_sh_t = jnp.broadcast_to(
            _NULL_SH_SPH, (sh_tiles, n_lights * CHUNK, 16)
        )
        cnt_sh_sph = jnp.zeros((n_tiles, n_lights), jnp.int32)

    # counts layout: [tri, sph, (sh_tri, sh_sph) per light]
    sh_cols = jnp.stack([cnt_sh_tri, cnt_sh_sph], axis=-1).reshape(
        n_tiles, 2 * n_lights
    )
    counts = jnp.concatenate(
        [cnt_tri[:, None], cnt_sph[:, None], sh_cols], axis=1
    ).astype(jnp.int32)

    return TileBins(
        t_idx=t_idx, t_valid=t_valid, s_idx=s_idx, s_valid=s_valid,
        tri_attr_t=tri_attr_t, sph_attr_t=sph_attr_t,
        tri_sh_t=tri_sh_t, sph_sh_t=sph_sh_t, counts=counts,
        overflow=overflow,
        k_tri=k_tri, k_sph=k_sph, k_sh_tri=k_sh_tri, k_sh_sph=k_sh_sph,
        nty=nty, ntx=ntx, projective=projective,
    )


def _gather_coefs(coef, idx, valid, null_col):
    """Camera-dependent per-frame gather: coef (C, P) -> (n_tiles, k, 16)."""
    c = coef.shape[0]
    g = coef.T[idx]
    g = jnp.where(valid[..., None], g, null_col[:c])
    pad = 16 - c
    if pad:
        g = jnp.concatenate(
            [g, jnp.zeros(g.shape[:2] + (pad,), jnp.float32)], axis=-1
        )
    return g

@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "shading", "shadows", "out_format",
                     "interpret"),
)
def _render_tiled_jit(
    packed,
    camera: Camera,
    bins: TileBins,
    *,
    height: int,
    width: int,
    shading: str,
    shadows: bool,
    out_format: str = "int",
    interpret: bool = False,
):
    from opencl_ray_tracer.models.xla_backend import render_xla_jit

    projective = camera.normalize
    if bins.projective != projective:
        raise ValueError(
            "TileBins/camera mismatch: pinhole cameras need bins computed "
            "with bin_scene(..., camera=camera)"
        )
    nty, ntx = bins.nty, bins.ntx
    n_tiles = nty * ntx

    if projective:
        tri_coef, sph_coef = _prep_projective_coefs(packed, camera)
        null_tri, null_sph = _NULL_TRI_PROJ, _NULL_SPH_PROJ
    else:
        tri_coef, sph_coef = _prep_affine_coefs(packed, camera)
        null_tri, null_sph = _NULL_TRI, _NULL_SPH

    def coef_table(coef, k, idx, valid, null):
        if k:
            return _gather_coefs(coef, idx, valid, null)
        row = np.concatenate([null, np.zeros(16 - null.shape[0], np.float32)])
        return jnp.broadcast_to(jnp.asarray(row), (n_tiles, CHUNK, 16))

    tri_coef_t = coef_table(tri_coef, bins.k_tri, bins.t_idx, bins.t_valid,
                            null_tri)
    sph_coef_t = coef_table(sph_coef, bins.k_sph, bins.s_idx, bins.s_valid,
                            null_sph)
    params = _camera_params(camera, packed.lights)
    out_packed = out_format == "packed"
    kernel = _build_kernel(
        ntx=ntx,
        n_lights=packed.lights.position.shape[0],
        shading=shading,
        shadows=shadows,
        projective=projective,
        out_packed=out_packed,
    )
    # program (t, s) writes image rows [s*BLOCK_ROWS, +BLOCK_ROWS) of tile t
    block = pl.BlockSpec(
        (BLOCK_ROWS, TILE_W), lambda t, s: ((t // ntx) * N_SUB + s, t % ntx)
    )
    frame = (nty * TILE_H, ntx * TILE_W)
    if out_packed:
        out_shape = jax.ShapeDtypeStruct(frame, jnp.int32)
        out_specs = block
    else:
        out_shape = [jax.ShapeDtypeStruct(frame, jnp.float32)] * 3
        out_specs = [block] * 3
    call = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_tiles, N_SUB),
        in_specs=[pl.BlockSpec()] * 8,
        out_specs=out_specs,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="octrt_fwd_tiled",
    )

    def tiled(operands):
        out = call(*operands)
        if out_packed:
            return out[:height, :width]
        r, g, b = (c[:height, :width] for c in out)
        return jnp.stack([r, g, b, jnp.full_like(r, 255.0)], axis=-1)

    def overflow(operands):
        del operands
        rgba = render_xla_jit(
            packed.unpack(), camera, height=height, width=width,
            shading=shading, shadows=shadows, row_chunk=8, as_int=False,
        )
        return pack_framebuffer_words(rgba) if out_packed else rgba

    operands = (
        params, bins.counts, tri_coef_t, bins.tri_attr_t, sph_coef_t,
        bins.sph_attr_t, bins.tri_sh_t, bins.sph_sh_t,
    )
    img = jax.lax.cond(bins.overflow, overflow, tiled, operands)
    if out_format == "int":
        return jnp.trunc(img).astype(jnp.int32)
    return img


def render_tiled(
    scene,
    camera: Camera,
    config: RenderConfig,
    interpret: Optional[bool] = None,
) -> jax.Array:
    return render_tiled_packed(scene.pack(), camera, config, interpret)


def render_tiled_packed(
    packed,
    camera: Camera,
    config: RenderConfig,
    interpret: Optional[bool] = None,
    bins: Optional[TileBins] = None,
) -> jax.Array:
    """Tiled+culled render.

    Supports both camera families: shared-direction (legacy ortho) and
    shared-origin pinhole (`normalize` cameras, whose origin derivatives dox
    and doy must be zero — the only normalize cameras this framework
    constructs). Pass precomputed `bins` (from bin_scene) for hot loops
    where the scene is fixed. Ortho bins depend on the camera only through
    its origin offset; pinhole bins depend on the full pose.

    `interpret` (default: config.interpret) runs the kernel in the Pallas
    interpreter; without it the kernel needs a GPU.

    Overflow policy: when called EAGERLY (outside jit), a tile exceeding
    cull_k auto-escalates — binning retries with doubled K until every
    candidate fits (bounded by the primitive count). Under jit the overflow
    flag is traced, so the lax.cond XLA fallback applies instead (never
    silently wrong either way)."""
    if interpret is None:
        interpret = config.interpret
    check_kernel_platform(interpret)
    if bins is None:
        k, shadow_k = config.cull_k, config.shadow_cull_k

        def make(k_, sk_):
            return bin_scene(
                packed,
                height=config.height,
                width=config.width,
                k=k_,
                shadows=config.shadows,
                shadow_k=sk_,
                camera=camera,
            )

        bins = make(k, shadow_k)
        k_max = _round_up(max(packed.n_tris, packed.n_spheres, 1), CHUNK)
        if not isinstance(bins.overflow, jax.core.Tracer):
            while bool(bins.overflow) and max(k, shadow_k) < k_max:
                k = min(2 * k, k_max)
                shadow_k = min(2 * shadow_k, k_max)
                from opencl_ray_tracer.utils.log import log_warning

                log_warning(
                    "tile candidate overflow: re-binning with cull_k=%d "
                    "shadow_cull_k=%d", k, shadow_k,
                )
                bins = make(k, shadow_k)
    return _render_tiled_jit(
        packed,
        camera,
        bins,
        height=config.height,
        width=config.width,
        shading=config.shading,
        shadows=config.shadows,
        out_format=config.framebuffer_dtype,
        interpret=interpret,
    )
