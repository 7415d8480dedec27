"""Tiled+culled kernels for the SOFT differentiable renderer, fwd AND bwd
(Pallas through Triton).

The soft renderer (diff/soft.py, the dense jnp twin and the oracle) gives
every primitive a smooth coverage, ranks primitives by a softmin over
depth, and shades the softmax-weighted hit. Densely that is O(pixels x
primitives) per quantity; here the same math runs per tile over culled
candidate lists:

1. BINNING (XLA): primitive screen bboxes padded by SOFT_CULL_SIGMAS *
   tau_edge — beyond 16 sigma the coverage sigmoids are below 1.2e-7.
   The dense twin ranks by depth plus log coverage, so at rare pixels a
   culled sliver far nearer than the covering surface still wins its
   softmin; there the two renderers differ (PERF.md, culling finding). Shadow
   candidates use the tile->light segment hull (fwd_tiled._bin_prims) with
   the same pad. Any tile over K falls back to the dense XLA twin for the
   frame via lax.cond (never silently wrong).
2. TABLES (XLA, differentiable): per-tile gathered coefficient rows. With a
   shared direction, Möller–Trumbore's u, v, t are affine in pixel coords,
   and the soft coverage consumes u, v, 1-u-v directly, so the triangle
   test is FMA + sigmoid. Spheres are tested from their centre and the
   pixel's origin: the quadratic-in-pixel form of d^2 cancels ~x^2 terms
   in f32 and moved sphere-silhouette gradients by ~1% at x ~ 1400.
   Per-primitive sigmoid scales are baked into the rows; triangle normals
   are pre-flipped against the shared direction. Pinhole cameras use
   projective rows instead. Because the gather is pure jnp,
   its jax.vjp IS the scatter-add from per-tile gradient rows back to the
   scene parameters.
3. FORWARD kernel: one program per (tile, block of image rows); an empty
   tile stores the background and returns. Otherwise each pixel streams
   the tile's candidates — one candidate per loop step, its row read as
   scalars shared by the block — with a running max and normalizer (the
   flash-attention form of the softmin), then shades once. It also
   stores the streaming finals and the per-light log visibility, one plane
   each, for the backward (forward-only renders write them too: one kernel,
   not two).
4. BACKWARD kernel: reads the streaming finals and the per-light log
   visibility that the forward stored, runs jax.vjp of the per-pixel
   shading once, and jax.vjp of each candidate's
   contribution (taken against the final running max, which the outputs
   are invariant to) inside the same candidate loops. A candidate's row
   gradient is a sum over the block's pixels, written to the program's own
   slot of a (tile, block, K, row) table — programs run in no order and
   share nothing — and XLA sums the blocks and scatter-adds the rows back
   through the gather's vjp.

Reference anchor: the device hot loop this differentiates is the redesign
of resources/shaders/rayTracer.cl:111-202 (SURVEY.md §2 #1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from opencl_ray_tracer.camera import Camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.diff.soft import (
    SHADOW_OFFSET,
    SHADOW_T_MIN,
    render_soft_jit,
)
from opencl_ray_tracer.kernels.fwd_tiled import (
    CHUNK,
    TILE_H,
    TILE_W,
    _bin_prims,
    _prep_projective_coefs,
    _prim_bboxes,
    _prim_z_extents,
    _tile_hit_z,
)
from opencl_ray_tracer.kernels.prep import (
    _LIGHT_STRIDE,
    _P_AMBIENT,
    _P_D0,
    _P_DDX,
    _P_DDY,
    _P_DOX,
    _P_DOY,
    _P_LIGHTS,
    _P_O0,
    _P_SHINE,
    _P_SPEC,
    _camera_params,
    _prep_affine_coefs,
    _round_up,
    _safe_norm_rows,
    _safe_unit_rows,
)
from opencl_ray_tracer.ops.intersect import EPSILON
from opencl_ray_tracer.ops.shading import LEGACY_FOG_MAX
from opencl_ray_tracer.runtime.backend import check_kernel_platform

NEG_BIG = -1e30
# Coverage sigmoids are exp-small this many tau_edge units outside a
# primitive: 16 sigma => sigmoid ~ 1.1e-7. A numerical pad, not a tuning
# knob (see the module docstring for where it is not invisible).
SOFT_CULL_SIGMAS = 16.0
# Pixel block per program: (rows, TILE_W) pixels on the given warps. Chosen
# on the H100 among three (fwd, bwd) pairs from per-call samples only; see
# PERF.md.
FWD_ROWS, FWD_WARPS = 8, 8
BWD_ROWS, BWD_WARPS = 4, 4

# ---------------------------------------------------------------------------
# Binning + per-frame gathered tables
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SoftBins:
    """Candidate index lists for the tiled soft kernels. Depends on the
    scene, tau_edge (bbox pad) and the camera: its ORIGIN OFFSET (row-shard
    shift) for shared-direction cameras, its full pose for pinholes."""

    t_idx: jax.Array      # (n_tiles, k_tri) int32
    t_valid: jax.Array
    s_idx: jax.Array      # (n_tiles, k_sph)
    s_valid: jax.Array
    tsh_idx: jax.Array    # (L, n_tiles, k_sh_tri)
    tsh_valid: jax.Array
    ssh_idx: jax.Array    # (L, n_tiles, k_sh_sph)
    ssh_valid: jax.Array
    counts: jax.Array     # (n_tiles, 2) int32: primary tri/sph candidates
    overflow: jax.Array   # () bool
    k_tri: int = dataclasses.field(metadata=dict(static=True), default=0)
    k_sph: int = dataclasses.field(metadata=dict(static=True), default=0)
    k_sh_tri: int = dataclasses.field(metadata=dict(static=True), default=0)
    k_sh_sph: int = dataclasses.field(metadata=dict(static=True), default=0)
    nty: int = dataclasses.field(metadata=dict(static=True), default=0)
    ntx: int = dataclasses.field(metadata=dict(static=True), default=0)
    # pinhole bins: perspective bboxes, full shared shadow lists
    projective: bool = dataclasses.field(
        metadata=dict(static=True), default=False
    )


def _pinhole_bboxes_soft(packed, camera, pad):
    """Perspective screen bboxes of primitives INFLATED by `pad` world
    units (the sigmoid-tail margin) — project the 8 corners of each
    primitive's padded AABB; any corner behind the near plane degrades to a
    conservative full-screen bbox (same scheme as fwd_tiled._pinhole_bboxes).
    """
    M = jnp.stack([camera.ddx, camera.ddy, camera.d0], axis=1)
    Minv = jnp.linalg.inv(M)
    big = 1e9
    signs = np.array(
        [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
         for sz in (-1.0, 1.0)], np.float32,
    )  # (8, 3)

    def box_of_aabb(lo, hi):  # (N, 3) each
        ctr = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo) + pad
        P = ctr[:, None, :] + half[:, None, :] * signs[None]  # (N, 8, 3)
        v = jnp.einsum("ij,nkj->nki", Minv, P - camera.o0)
        w = v[..., 2]
        front = w > 1e-6
        ok = jnp.all(front, axis=1)
        sw = jnp.where(front, w, 1.0)
        sx = v[..., 0] / sw
        sy = v[..., 1] / sw
        ppad = 1.0
        return (
            jnp.where(ok, jnp.min(sx, 1) - ppad, -big),
            jnp.where(ok, jnp.max(sx, 1) + ppad, big),
            jnp.where(ok, jnp.min(sy, 1) - ppad, -big),
            jnp.where(ok, jnp.max(sy, 1) + ppad, big),
        )

    v0 = packed.tri_v0.T
    v1 = v0 + packed.tri_e1.T
    v2 = v0 + packed.tri_e2.T
    tri_lo = jnp.minimum(jnp.minimum(v0, v1), v2)
    tri_hi = jnp.maximum(jnp.maximum(v0, v1), v2)
    c = packed.sph_origin.T
    r = packed.sph_radius[0][:, None]
    return box_of_aabb(tri_lo, tri_hi), box_of_aabb(c - r, c + r)


def _pad_box(box, pad):
    x0, x1, y0, y1 = box
    return (x0 - pad, x1 + pad, y0 - pad, y1 + pad)


def _bin_soft(packed, tau_e, camera, *, height, width, k, shadows,
              shadow_k):
    """Tile binning with tau-padded bboxes. Pure jnp (tau_e may be traced);
    the caller stop-gradients the result (culling is a discrete choice).
    The camera contributes its origin offset (o0.xy): tile rects shift into
    world coordinates so the shard_map camera-shift trick bins correctly
    per row shard."""
    projective = camera.normalize
    offs = None if projective else (camera.o0[0], camera.o0[1])
    nty = _round_up(height, TILE_H) // TILE_H
    ntx = _round_up(width, TILE_W) // TILE_W
    n_tiles = nty * ntx
    n_lights = packed.lights.position.shape[0]
    pad = SOFT_CULL_SIGMAS * tau_e
    if projective:
        tri_box, sph_box = _pinhole_bboxes_soft(packed, camera, pad)
    else:
        tri_box, sph_box = _prim_bboxes(packed)
        tri_box = _pad_box(tri_box, pad)
        sph_box = _pad_box(sph_box, pad)

    # k values rounded to the table granularity (_bin_prims pads columns
    # past the primitive count)
    kg = CHUNK
    k_tri = (
        _round_up(min(k, _round_up(packed.n_tris, CHUNK)), kg)
        if packed.n_tris else 0
    )
    k_sph = (
        _round_up(min(k, _round_up(packed.n_spheres, CHUNK)), kg)
        if packed.n_spheres else 0
    )
    overflow = jnp.zeros((), bool)
    zero_cnt = jnp.zeros((n_tiles,), jnp.int32)
    if k_tri:
        t_idx, t_valid, cnt_tri, over = _bin_prims(
            tri_box, packed.n_tris, nty, ntx, k_tri, offs=offs
        )
        overflow |= over
    else:
        t_idx = jnp.zeros((n_tiles, CHUNK), jnp.int32)
        t_valid = jnp.zeros((n_tiles, CHUNK), bool)
        cnt_tri = zero_cnt
    if k_sph:
        s_idx, s_valid, cnt_sph, over = _bin_prims(
            sph_box, packed.n_spheres, nty, ntx, k_sph, offs=offs
        )
        overflow |= over
    else:
        s_idx = jnp.zeros((n_tiles, CHUNK), jnp.int32)
        s_valid = jnp.zeros((n_tiles, CHUNK), bool)
        cnt_sph = zero_cnt

    # Pinhole shadow rays fan out from hit points anywhere in the tile's
    # view frustum toward the light; no screen-space corridor bounds the
    # occluder set, so projective shadow candidates are the FULL primitive
    # set (one shared table, see _gather_soft_tables).
    if projective:
        k_sh_tri = (
            _round_up(packed.padded_tris, kg)
            if (shadows and packed.n_tris) else 0
        )
        k_sh_sph = (
            _round_up(packed.padded_spheres, kg)
            if (shadows and packed.n_spheres) else 0
        )
    else:
        k_sh_tri = (
            _round_up(min(shadow_k, _round_up(packed.n_tris, CHUNK)), kg)
            if (shadows and packed.n_tris) else 0
        )
        k_sh_sph = (
            _round_up(min(shadow_k, _round_up(packed.n_spheres, CHUNK)), kg)
            if (shadows and packed.n_spheres) else 0
        )
    lpos = packed.lights.position

    # z inputs of the segment-hull shadow culling: soft pad = the sigmoid
    # tail width (the t-gates extend the segment by ~4 tau_g, well inside
    # the SOFT_CULL_SIGMAS pad) + the shadow-ray origin offset. tile_z is
    # the PER-TILE hit-z slab over the primary candidates: the softmin t
    # is a convex combination of candidate hits (null slots carry exactly
    # zero weight), so per-tile hit z stays inside the candidates' padded
    # z hull.

    z_pad = pad + SHADOW_OFFSET
    tri_zext, sph_zext = _prim_z_extents(packed, z_pad)
    tile_z = _tile_hit_z(
        t_idx, t_valid, s_idx, s_valid, tri_zext, sph_zext, nty, ntx
    )

    def bin_sh(box, n_real, ksh, prim_z):
        idxs, valids, cnts = [], [], []
        over = jnp.zeros((), bool)
        for li in range(n_lights):
            i_, v_, c_, o_ = _bin_prims(
                box, n_real, nty, ntx, ksh,
                light_xy=(lpos[li, 0], lpos[li, 1]), offs=offs,
                light_z=lpos[li, 2], prim_z=prim_z, tile_z=tile_z,
            )
            idxs.append(i_)
            valids.append(v_)
            cnts.append(c_)
            over |= o_
        return jnp.stack(idxs), jnp.stack(valids), jnp.stack(cnts), over

    # per-(light, tile) shadow candidate counts: the kernels loop over
    # exactly the candidates below the count (candidates are compacted to
    # the front by _bin_prims' top_k), so a tile pays for what its
    # corridors actually contain, not for the static-K worst case.
    sh_cnt_tri = jnp.zeros((n_lights, n_tiles), jnp.int32)
    sh_cnt_sph = jnp.zeros((n_lights, n_tiles), jnp.int32)
    if k_sh_tri and not projective:
        tsh_idx, tsh_valid, sh_cnt_tri, over = bin_sh(
            tri_box, packed.n_tris, k_sh_tri, tri_zext
        )
        overflow |= over
    else:
        tsh_idx = jnp.zeros((n_lights, n_tiles, CHUNK), jnp.int32)
        tsh_valid = jnp.zeros((n_lights, n_tiles, CHUNK), bool)
        if k_sh_tri:  # projective: full shared list, every slot live
            sh_cnt_tri = jnp.full(
                (n_lights, n_tiles), packed.n_tris, jnp.int32
            )
    if k_sh_sph and not projective:
        ssh_idx, ssh_valid, sh_cnt_sph, over = bin_sh(
            sph_box, packed.n_spheres, k_sh_sph, sph_zext
        )
        overflow |= over
    else:
        ssh_idx = jnp.zeros((n_lights, n_tiles, CHUNK), jnp.int32)
        ssh_valid = jnp.zeros((n_lights, n_tiles, CHUNK), bool)
        if k_sh_sph:
            sh_cnt_sph = jnp.full(
                (n_lights, n_tiles), packed.n_spheres, jnp.int32
            )

    # counts layout: [tri, sph, (sh_tri, sh_sph) per light] — the kernels'
    # loop trip counts (same layout as fwd_tiled's).
    cols = [cnt_tri, cnt_sph]
    for li in range(n_lights):
        cols += [sh_cnt_tri[li], sh_cnt_sph[li]]
    return SoftBins(
        t_idx=t_idx, t_valid=t_valid, s_idx=s_idx, s_valid=s_valid,
        tsh_idx=tsh_idx, tsh_valid=tsh_valid,
        ssh_idx=ssh_idx, ssh_valid=ssh_valid,
        counts=jnp.stack(cols, axis=1),
        overflow=overflow,
        k_tri=k_tri, k_sph=k_sph, k_sh_tri=k_sh_tri, k_sh_sph=k_sh_sph,
        nty=nty, ntx=ntx, projective=projective,
    )


# Null rows force cov == 0 EXACTLY (exp underflow), so a masked slot
# contributes nothing to the image or the gradients — static-K masked loops
# therefore equal ragged skipping bit-for-bit.
_NULL_TRI16 = np.array(
    [-1e9, 0, 0, 0, 0, 0, 0, 0, 0, 1.0, 1.0, 1.0, 0, 0, 0, 0], np.float32
)  # u = -1e9 -> sigmoid(-1e9) == 0
_NULL_SPH16 = np.array(
    [0, 0, 0, -1e18, 1.0, 0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32
)  # r2 = -1e18 -> margin sigmoid 0 for any ray
_NULL_TSH16 = np.zeros((16,), np.float32)  # zero verts -> det 0 -> cov 0
# projective nulls: det == 0 fails |det| >= eps*|d|; tca = -1e9 kills the
# sphere's facing sigmoid exactly (margin may saturate to 1; the product
# still underflows to 0).
_NULL_TRI16_PROJ = np.zeros((16,), np.float32)
_NULL_SPH16_PROJ = np.array(
    [-1e9, 0, 0, 0, 0, 1.0, 0, 0, 0, 1e9, 1.0, 0, 0, 0, 0, 0], np.float32
)
_NULL_SSH16 = np.array(
    [0, 0, 1e9, 0, 1.0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32
)  # far occluder, r2 = 0


def _gather_soft_tables(packed, camera, tau_e, bins: SoftBins):
    """Per-frame per-tile candidate tables. Pure jnp and differentiable —
    its jax.vjp scatter-adds per-tile gradient tables back onto the
    PackedScene / Camera / tau_e inputs.

    Shared-direction (ortho) rows:
    tri16:       [u0,ux,uy, v0,vx,vy, t0,tx,ty, itu,itv,itw, 0 x4]
                 (affine Möller–Trumbore + sigmoid scales s/tau_e)
    tri_alb8:    [r,g,b, n(pre-flipped vs shared dir), 0,0]
    sph16:       [cx,cy,cz, r2, inv2r, rinv, twor, 0 x9]

    Shared-origin (pinhole, bins.projective) rows:
    tri16:       [det0,detx,dety, un0,unx,uny, vn0,vnx,vny, tnum,
                  itu,itv,itw, n(3) UNflipped (flip is per-pixel)]
    sph16:       [tc0,tcx,tcy, l2, r2, inv2r, rinv, cx,cy,cz, twor, 0 x5]
    and the shadow tables are the FULL primitive set shared by every tile
    (leading dim 1).

    Common:
    sph_alb8:    [r,g,b, 0 x5]
    tri_sh16:    [v0(3), e1(3), e2(3), itu,itv,itw, 0 x4]  (geometric)
    sph_sh16:    [cx,cy,cz, r2, inv2r, twor, 0 x10]
    """
    projective = bins.projective
    e1t, e2t = packed.tri_e1.T, packed.tri_e2.T
    s1 = _safe_norm_rows(e1t)
    s2 = _safe_norm_rows(e2t)
    itu = jnp.maximum(s1, 1e-6) / tau_e
    itv = jnp.maximum(s2, 1e-6) / tau_e
    itw = jnp.maximum(0.5 * (s1 + s2), 1e-6) / tau_e
    tp_ = packed.padded_tris
    sp_ = packed.padded_spheres
    n = _safe_unit_rows(jnp.cross(e1t, e2t))

    r = packed.sph_radius[0]
    twor = jnp.maximum(2.0 * r, 1e-6)
    inv2r = 1.0 / twor
    rinv = jnp.where(r > 0, 1.0 / jnp.where(r > 0, r, 1.0), 0.0)

    if projective:
        tri10, sph5 = _prep_projective_coefs(packed, camera)
        tri16 = jnp.concatenate(
            [tri10, itu[None], itv[None], itw[None], n.T], axis=0
        ).T  # (Tp, 16): normals UNflipped — flip is per-pixel in-kernel
        tri_alb8 = jnp.concatenate(
            [packed.tri_colour.T[:, :3], jnp.zeros((tp_, 5))], axis=1
        )
        sph16 = jnp.concatenate(
            [
                sph5, inv2r[None], rinv[None], packed.sph_origin,
                twor[None], jnp.zeros((5, sp_)),
            ],
            axis=0,
        ).T  # (Sp, 16)
    else:
        tri9, _ = _prep_affine_coefs(packed, camera)
        tri16 = jnp.concatenate(
            [tri9, itu[None], itv[None], itw[None], jnp.zeros((4, tp_))],
            axis=0,
        ).T  # (Tp, 16)
        d0 = camera.d0
        fl = jnp.where(jnp.sum(n * d0, -1) > 0, -1.0, 1.0)[:, None]
        tri_alb8 = jnp.concatenate(
            [packed.tri_colour.T[:, :3], n * fl, jnp.zeros((tp_, 2))], axis=1
        )
        sph16 = jnp.concatenate(
            [
                packed.sph_origin, (r * r)[None], inv2r[None], rinv[None],
                twor[None], jnp.zeros((9, sp_)),
            ],
            axis=0,
        ).T  # (Sp, 16)
    sph_alb8 = jnp.concatenate(
        [packed.sph_colour.T[:, :3], jnp.zeros((sp_, 5))], axis=1
    )

    tri_sh16 = jnp.concatenate(
        [
            packed.tri_v0, packed.tri_e1, packed.tri_e2,
            itu[None], itv[None], itw[None], jnp.zeros((4, tp_)),
        ],
        axis=0,
    ).T
    sph_sh16 = jnp.concatenate(
        [
            packed.sph_origin, (r * r)[None], inv2r[None], twor[None],
            jnp.zeros((10, sp_)),
        ],
        axis=0,
    ).T

    def gather(rows, idx, valid, null):
        g = rows[idx]
        return jnp.where(valid[..., None], g, null)

    null_tri = _NULL_TRI16_PROJ if projective else _NULL_TRI16
    null_sph = _NULL_SPH16_PROJ if projective else _NULL_SPH16
    tri_t = gather(tri16, bins.t_idx, bins.t_valid, null_tri)
    tri_alb_t = gather(tri_alb8, bins.t_idx, bins.t_valid, 0.0)
    sph_t = gather(sph16, bins.s_idx, bins.s_valid, null_sph)
    sph_alb_t = gather(sph_alb8, bins.s_idx, bins.s_valid, 0.0)
    n_lights = packed.lights.position.shape[0]
    if projective:
        # full shared shadow lists, one table used by every tile
        real_t = (jnp.arange(tp_) < packed.n_tris)[:, None]
        real_s = (jnp.arange(sp_) < packed.n_spheres)[:, None]
        tsh_rows = jnp.where(real_t, tri_sh16, _NULL_TSH16)
        ssh_rows = jnp.where(real_s, sph_sh16, _NULL_SSH16)
        kt = max(bins.k_sh_tri, CHUNK)
        ks = max(bins.k_sh_sph, CHUNK)

        def pad_rows(rows, kk, null):
            if rows.shape[0] >= kk:
                return rows[:kk]
            extra = jnp.broadcast_to(null, (kk - rows.shape[0], 16))
            return jnp.concatenate([rows, extra], axis=0)

        tsh_rows = pad_rows(tsh_rows, kt, _NULL_TSH16)
        ssh_rows = pad_rows(ssh_rows, ks, _NULL_SSH16)
        tsh_t = jnp.broadcast_to(
            tsh_rows[None], (n_lights, kt, 16)
        ).reshape(1, n_lights * kt, 16)
        ssh_t = jnp.broadcast_to(
            ssh_rows[None], (n_lights, ks, 16)
        ).reshape(1, n_lights * ks, 16)
    else:
        tsh_t = jnp.concatenate(
            [
                gather(
                    tri_sh16, bins.tsh_idx[li], bins.tsh_valid[li],
                    _NULL_TSH16,
                )
                for li in range(n_lights)
            ],
            axis=1,
        )  # (n_tiles, L*k_sh_tri, 16)
        ssh_t = jnp.concatenate(
            [
                gather(
                    sph_sh16, bins.ssh_idx[li], bins.ssh_valid[li],
                    _NULL_SSH16,
                )
                for li in range(n_lights)
            ],
            axis=1,
        )
    return tri_t, tri_alb_t, sph_t, sph_alb_t, tsh_t, ssh_t


# ---------------------------------------------------------------------------
# Tile math: one candidate at a time against a block of pixels. Candidate
# rows `tab`/`alb` are tuples of scalars, pixel quantities are (rows, W)
# arrays. Every traced value the tests read flows through an EXPLICIT ctx
# pytree so jax.vjp can route gradients back to camera/light params and
# the temperatures (a closure would silently treat them as constants).
# ---------------------------------------------------------------------------

# ctx entries that are pure functions of the pixel coordinates: constants
# of the kernel, never differentiated
_CONST_KEYS = ("x", "y")


def _ctx_make(pv, tau_d, tau_e, x, y, *, projective: bool, n_lights: int):
    """Per-block shared context: ray bundles, light/shading scalars, temperatures. A plain dict pytree."""
    o = tuple(
        pv[_P_O0 + q] + x * pv[_P_DOX + q] + y * pv[_P_DOY + q]
        for q in range(3)
    )
    if projective:
        du = tuple(
            pv[_P_D0 + q] + x * pv[_P_DDX + q] + y * pv[_P_DDY + q]
            for q in range(3)
        )
        len2 = jnp.maximum(
            du[0] * du[0] + du[1] * du[1] + du[2] * du[2], 1e-20
        )
        inv_len = jax.lax.rsqrt(len2)
        len_d = len2 * inv_len
        d = tuple(c_ * inv_len for c_ in du)  # unit, per pixel
    else:
        d = (pv[_P_D0], pv[_P_D0 + 1], pv[_P_D0 + 2])  # shared-dir scalars
        inv_len = None
        len_d = None
    lights = tuple(
        (
            (pv[b], pv[b + 1], pv[b + 2]),
            (pv[b + 3], pv[b + 4], pv[b + 5]),
            pv[b + 6],
        )
        for b in (
            _P_LIGHTS + li * _LIGHT_STRIDE for li in range(n_lights)
        )
    )
    return dict(
        o=o, d=d, inv_len=inv_len, len_d=len_d, x=x, y=y,
        ambient=pv[_P_AMBIENT], spec=pv[_P_SPEC], shine=pv[_P_SHINE],
        lights=lights,
        tau_e=tau_e,
        inv_td=1.0 / tau_d,
        inv_te=1.0 / tau_e,
        inv_te6=1.0 / jnp.maximum(tau_e, 1e-6),
    )


# -- candidate tests ---------------------------------------------------------
# tri test returns (t, cov, n_or_None): ortho folds the pre-flipped normal
# into the albedo row (n is None); projective flips the stored unit normal
# per pixel and returns it.

def _tri_test(tab, ctx, projective: bool):
    x, y = ctx["x"], ctx["y"]
    c = lambda q: tab[q]
    if projective:
        d, len_d = ctx["d"], ctx["len_d"]
        det = c(0) + x * c(1) + y * c(2)
        un = c(3) + x * c(4) + y * c(5)
        vn = c(6) + x * c(7) + y * c(8)
        det_ok = jnp.abs(det) >= EPSILON * len_d
        inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
        u = un * inv_det
        v = vn * inv_det
        t = c(9) * inv_det * len_d
        cov = (
            jax.nn.sigmoid(u * c(10))
            * jax.nn.sigmoid(v * c(11))
            * jax.nn.sigmoid((1.0 - u - v) * c(12))
        )
        cov = jnp.where(det_ok, cov, 0.0)
        n0 = (c(13), c(14), c(15))
        ndotd = n0[0] * d[0] + n0[1] * d[1] + n0[2] * d[2]
        fl = jnp.where(ndotd > 0, -1.0, 1.0)
        return t, cov, (n0[0] * fl, n0[1] * fl, n0[2] * fl)
    u = c(0) + x * c(1) + y * c(2)
    v = c(3) + x * c(4) + y * c(5)
    t = c(6) + x * c(7) + y * c(8)
    cov = (
        jax.nn.sigmoid(u * c(9))
        * jax.nn.sigmoid(v * c(10))
        * jax.nn.sigmoid((1.0 - u - v) * c(11))
    )
    return t, cov, None


def _sph_test(tab, ctx, projective: bool):
    x, y = ctx["x"], ctx["y"]
    o, d = ctx["o"], ctx["d"]
    c = lambda q: tab[q]
    if projective:
        tca = (c(0) + x * c(1) + y * c(2)) * ctx["inv_len"]
        d2 = c(3) - tca * tca
        r2, inv2r, rinv = c(4), c(5), c(6)
        ctr = (c(7), c(8), c(9))
        twor = c(10)
    else:
        ctr = (c(0), c(1), c(2))
        lx, ly, lz = ctr[0] - o[0], ctr[1] - o[1], ctr[2] - o[2]
        tca = lx * d[0] + ly * d[1] + lz * d[2]
        d2 = lx * lx + ly * ly + lz * lz - tca * tca
        r2, inv2r, rinv, twor = c(3), c(4), c(5), c(6)
    margin = (r2 - d2) * inv2r
    cov = (
        jax.nn.sigmoid(margin * ctx["inv_te"])
        * jax.nn.sigmoid(tca * ctx["inv_te6"])
    )
    q_ = r2 - d2
    beta = jnp.maximum(ctx["tau_e"], 1e-3) * twor
    thc = jnp.sqrt(beta * jax.nn.softplus(q_ / beta) + 1e-12)
    t = tca - thc
    nx = (o[0] + t * d[0] - ctr[0]) * rinv
    ny = (o[1] + t * d[1] - ctr[1]) * rinv
    nz = (o[2] + t * d[2] - ctr[2]) * rinv
    return t, cov, (nx, ny, nz)


def _tri_sh_test(tab, so, sd):
    c = lambda q: tab[q]
    v0 = (c(0), c(1), c(2))
    e1 = (c(3), c(4), c(5))
    e2 = (c(6), c(7), c(8))
    pvx = sd[1] * e2[2] - sd[2] * e2[1]
    pvy = sd[2] * e2[0] - sd[0] * e2[2]
    pvz = sd[0] * e2[1] - sd[1] * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    det_ok = jnp.abs(det) >= EPSILON
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    tvx, tvy, tvz = so[0] - v0[0], so[1] - v0[1], so[2] - v0[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1[2] - tvz * e1[1]
    qvy = tvz * e1[0] - tvx * e1[2]
    qvz = tvx * e1[1] - tvy * e1[0]
    v = (sd[0] * qvx + sd[1] * qvy + sd[2] * qvz) * inv_det
    t = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv_det
    cov = (
        jax.nn.sigmoid(u * c(9))
        * jax.nn.sigmoid(v * c(10))
        * jax.nn.sigmoid((1.0 - u - v) * c(11))
    )
    return t, jnp.where(det_ok, cov, 0.0)


def _sph_sh_test(tab, so, sd, ctx):
    c = lambda q: tab[q]
    lx, ly, lz = c(0) - so[0], c(1) - so[1], c(2) - so[2]
    tca = lx * sd[0] + ly * sd[1] + lz * sd[2]
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    r2, inv2r, twor = c(3), c(4), c(5)
    margin = (r2 - d2) * inv2r
    cov = (
        jax.nn.sigmoid(margin * ctx["inv_te"])
        * jax.nn.sigmoid(tca * ctx["inv_te6"])
    )
    q_ = r2 - d2
    beta = jnp.maximum(ctx["tau_e"], 1e-3) * twor
    thc = jnp.sqrt(beta * jax.nn.softplus(q_ / beta) + 1e-12)
    return tca - thc, cov


def _rank(t, cov, ctx):
    """Validity-cut depth logit — identical to diff/soft.py
    _soft_aggregate_planar (negative-t-wins quirk preserved)."""
    return jnp.where(
        cov > 1e-12,
        -t * ctx["inv_td"] + jnp.log(jnp.clip(cov, 1e-12, 1.0)),
        NEG_BIG,
    )


def _log_miss(cov):
    return jnp.log1p(-jnp.clip(cov, 0.0, 1.0 - 1e-6))


# -- per-candidate terms -------------------------------------------------------
# Streaming finals: aggregate modes (phong, lambert + shadows) carry
# [m, z, st, s0..s5, snx, sny, snz, bacc] — s0..s2 the weighted albedo, s3..s5
# the weighted pre-flipped ortho triangle normal from the albedo row, sn the
# weighted per-pixel normals; per-primitive-shading modes (legacy, lambert)
# carry [m, z, sr, sg, sb, bacc].

def _n_finals(aggregate: bool) -> int:
    return 13 if aggregate else 6


def _agg_terms(t, n, alb, e):
    """One candidate's (z, st, s0..s5, snx, sny, snz) terms at weight e."""
    sn = (
        tuple(e * c for c in n) if n is not None
        else (jnp.zeros_like(e),) * 3
    )
    return (e, e * t) + tuple(e * alb[q] for q in range(6)) + sn


def _nonagg_terms(alb, ctx, t, n, e, kind, shading, n_lights):
    """One candidate's (z, sr, sg, sb) terms: weight times shaded colour."""
    if shading == "legacy":
        s = e * (255.0 - t * (255.0 / LEGACY_FOG_MAX))
        return (e,) + tuple(s * alb[q] for q in range(3))
    # lambert, no shadows
    o, d = ctx["o"], ctx["d"]
    px = o[0] + t * d[0]
    py = o[1] + t * d[1]
    pz = o[2] + t * d[2]
    if kind == "tri" and n is None:
        n = (alb[3], alb[4], alb[5])  # ortho: pre-flipped normal row
    w = ctx["ambient"] * e
    acc = [w * alb[q] for q in range(3)]
    for lp, lc, lint in ctx["lights"]:
        tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
        dist = jnp.sqrt(jnp.maximum(tlx * tlx + tly * tly + tlz * tlz, 1e-20))
        ndotl = jnp.maximum((n[0] * tlx + n[1] * tly + n[2] * tlz) / dist, 0.0)
        we = e * (lint * ndotl)
        for q in range(3):
            acc[q] = acc[q] + lc[q] * (we * alb[q])
    return (e,) + tuple(a * 255.0 for a in acc)


def _terms(tab, alb, ctx, e_of, kind, *, projective, aggregate, shading,
           n_lights, **_):
    """(terms, miss) of one candidate, its weight given by e_of(logit)."""
    t, cov, n = (_tri_test if kind == "tri" else _sph_test)(
        tab, ctx, projective
    )
    logit = _rank(t, cov, ctx)
    e, extra = e_of(logit)
    if aggregate:
        terms = _agg_terms(t, n, alb, e)
    else:
        terms = _nonagg_terms(alb, ctx, t, n, e, kind, shading, n_lights)
    return terms, _log_miss(cov), extra


def _stream(loaders, ctx, counts, *, shape, **cfg):
    """Streaming softmin pass over the tile's candidates -> finals."""
    aggregate = cfg["aggregate"]

    def body_for(kind):
        load = loaders[0] if kind == "tri" else loaders[1]

        def body(i, carry):
            tab, alb = load(i)
            m = carry[0]

            def e_of(logit):
                m_new = jnp.maximum(m, logit)
                return jnp.exp(logit - m_new), m_new

            terms, miss, m_new = _terms(tab, alb, ctx, e_of, kind, **cfg)
            scale = jnp.exp(m - m_new)
            acc = tuple(a * scale + b for a, b in zip(carry[1:-1], terms))
            return (m_new,) + acc + (carry[-1] + miss,)

        return body

    zero = jnp.zeros(shape, jnp.float32)
    carry = (jnp.full(shape, NEG_BIG, jnp.float32),) + (zero,) * (
        _n_finals(aggregate) - 1
    )
    carry = jax.lax.fori_loop(0, counts[0], body_for("tri"), carry)
    return jax.lax.fori_loop(0, counts[1], body_for("sph"), carry)


def _contrib(tab, alb, ctx, m, kind, **cfg):
    """One candidate's finals terms against the FINAL running max m.
    Streaming-with-rescaling equals summing these (every term ends up
    scaled by exp(-m)), and the outputs depend on the finals only through
    m-invariant ratios (st/z, s/z, ...; bacc has no m), so holding m
    constant in the backward is EXACT (the flash-attention bwd trick)."""
    terms, miss, _ = _terms(
        tab, alb, ctx, lambda logit: (jnp.exp(logit - m), None), kind, **cfg
    )
    return terms + (miss,)


def _geom(f, ctx):
    """Aggregates -> shading geometry: normalized hit attributes, view
    vector, background weight, and per-light shadow-ray frames."""
    z, st, s0, s1, s2, s3, s4, s5, snx, sny, snz, bacc = f
    o, d = ctx["o"], ctx["d"]
    zinv = 1.0 / jnp.maximum(z, 1e-20)
    t_hat = st * zinv
    nx = (s3 + snx) * zinv
    ny = (s4 + sny) * zinv
    nz = (s5 + snz) * zinv
    ninv = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    px = o[0] + t_hat * d[0]
    py = o[1] + t_hat * d[1]
    pz = o[2] + t_hat * d[2]
    vinv = jax.lax.rsqrt(
        jnp.maximum(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-20)
    )
    sos, sds, dists = [], [], []
    for lp, _, _ in ctx["lights"]:
        tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
        dist = jnp.sqrt(jnp.maximum(tlx * tlx + tly * tly + tlz * tlz, 1e-20))
        sds.append((tlx / dist, tly / dist, tlz / dist))
        sos.append((
            px + SHADOW_OFFSET * nx,
            py + SHADOW_OFFSET * ny,
            pz + SHADOW_OFFSET * nz,
        ))
        dists.append(dist)
    return dict(
        n=(nx, ny, nz),
        a=(s0 * zinv, s1 * zinv, s2 * zinv),
        v=(-d[0] * vinv, -d[1] * vinv, -d[2] * vinv),
        w_bg=jnp.exp(bacc),
        sd=tuple(sds),
        so=tuple(sos),
        dist=tuple(dists),
    )


def _shade(geom, logvis, ctx, *, shading: str):
    """Aggregate-then-shade combine -> (r, g, b)."""
    nx, ny, nz = geom["n"]
    vx, vy, vz = geom["v"]
    diff = [0.0, 0.0, 0.0]
    spec = [0.0, 0.0, 0.0]
    for li, (_, lc, lint) in enumerate(ctx["lights"]):
        ldx, ldy, ldz = geom["sd"][li]
        ndotl = jnp.maximum(nx * ldx + ny * ldy + nz * ldz, 0.0)
        vis = jnp.exp(logvis[li]) if logvis is not None else 1.0
        wd = lint * ndotl * vis
        for q in range(3):
            diff[q] = diff[q] + wd * lc[q]
        if shading == "phong":
            two_ndl = 2.0 * (nx * ldx + ny * ldy + nz * ldz)
            rx = two_ndl * nx - ldx
            ry = two_ndl * ny - ldy
            rz = two_ndl * nz - ldz
            rdotv = jnp.maximum(rx * vx + ry * vy + rz * vz, 0.0)
            ws = (
                ctx["spec"]
                * jnp.exp(ctx["shine"] * jnp.log(jnp.maximum(rdotv, 1e-20)))
                * lint
                * vis
                * (ndotl > 0.0)
            )
            for q in range(3):
                spec[q] = spec[q] + ws * lc[q]
    one_m_bg = 1.0 - geom["w_bg"]
    return tuple(
        jnp.clip(
            one_m_bg * (a * (ctx["ambient"] + diff[q]) + spec[q]) * 255.0,
            0.0, 255.0,
        )
        for q, a in enumerate(geom["a"])
    )


def _shade_nonagg(f, *, shading: str):
    """Per-primitive-shading normalize: (z, sr, sg, sb, bacc) -> (r, g, b)."""
    z, sr, sg, sb, bacc = f
    zinv = 1.0 / jnp.maximum(z, 1e-20)
    w_fg = 1.0 - jnp.exp(bacc)
    out = tuple(w_fg * s * zinv for s in (sr, sg, sb))
    if shading != "legacy":
        out = tuple(jnp.clip(c, 0.0, 255.0) for c in out)
    return out


def _occ_term(tab, so, sd, dist, ctx, kind):
    """One occluder's log-visibility term."""
    if kind == "tri":
        t2, cov2 = _tri_sh_test(tab, so, sd)
    else:
        t2, cov2 = _sph_sh_test(tab, so, sd, ctx)
    tau_g = jnp.maximum(ctx["tau_e"], 1e-4)
    shift = jnp.maximum(SHADOW_T_MIN, 4.0 * tau_g)
    occ = (
        cov2
        * jax.nn.sigmoid((t2 - shift) / tau_g)
        * jax.nn.sigmoid((dist - t2) / tau_g)
    )
    return _log_miss(occ)


def _occlusion(sh_loaders, geom, ctx, sh_counts, li):
    """Log visibility of light li over its occluder candidates."""
    so, sd, dist = geom["so"][li], geom["sd"][li], geom["dist"][li]

    def body_for(kind):
        load = sh_loaders[0] if kind == "tri" else sh_loaders[1]
        return lambda i, lv: lv + _occ_term(load(li, i), so, sd, dist, ctx,
                                            kind)

    lv = jnp.zeros(dist.shape, jnp.float32)
    lv = jax.lax.fori_loop(0, sh_counts[0], body_for("tri"), lv)
    return jax.lax.fori_loop(0, sh_counts[1], body_for("sph"), lv)


def _tile_forward(ctx, loaders, counts, *, shape, **cfg):
    """The soft pipeline on one pixel block -> ((r, g, b), finals), finals
    being the streaming state plus, with shadows, the per-light log
    visibility (what the backward reads).

    loaders = (load_tri, load_sph, load_tri_sh, load_sph_sh): candidate
    index -> (row, albedo row) for primaries, (light, index) -> row for
    occluders. counts = (cnt_tri, cnt_sph, ((sh_tri, sh_sph) per light))."""
    fin = _stream(loaders[:2], ctx, counts[:2], shape=shape, **cfg)
    if not cfg["aggregate"]:
        return _shade_nonagg(fin[1:], shading=cfg["shading"]), fin
    geom = _geom(fin[1:], ctx)
    logvis = None
    if cfg["shadows"]:
        logvis = tuple(
            _occlusion(loaders[2:], geom, ctx, counts[2][li], li)
            for li in range(cfg["n_lights"])
        )
    rgb = _shade(geom, logvis, ctx, shading=cfg["shading"])
    return rgb, fin + (logvis or ())


def _tile_backward(pv, tau_d, tau_e, x, y, g_rgb, loaders, counts, stored,
                   store_rows, *, shape, **cfg):
    """Gradients of one pixel block: returns (g_pv, g_tau_d, g_tau_e) and
    hands every candidate's row gradients to store_rows(kind, index,
    g_row, g_alb) (occluders: store_rows(("sh", kind, light), ...)).
    stored: the forward's finals (see _tile_forward)."""
    projective, aggregate = cfg["projective"], cfg["aggregate"]
    shading, n_lights = cfg["shading"], cfg["n_lights"]
    tree_add = lambda a, b: jax.tree_util.tree_map(jnp.add, a, b)

    ctx, builder_vjp = jax.vjp(
        lambda pv_, td_, te_: _ctx_make(
            pv_, td_, te_, x, y, projective=projective, n_lights=n_lights
        ),
        pv, tau_d, tau_e,
    )
    ctx_const = {q: ctx[q] for q in _CONST_KEYS}
    ctx_diff = {q: v for q, v in ctx.items() if q not in _CONST_KEYS}
    with_const = lambda cd: {**cd, **ctx_const}
    split = lambda c: {q: v for q, v in c.items() if q not in _CONST_KEYS}

    n_fin = _n_finals(aggregate)
    m, f = stored[0], stored[1:n_fin]
    logvis = tuple(stored[n_fin:]) or None

    if aggregate:
        geom, geom_vjp = jax.vjp(_geom, f, ctx)
        _, shade_vjp = jax.vjp(
            lambda gm, lv, c_: _shade(gm, lv, c_, shading=shading),
            geom, logvis, ctx,
        )
        g_geom, g_logvis, gctx = shade_vjp(g_rgb)
        gctx = split(gctx)

        if cfg["shadows"]:
            g_so, g_sd, g_dist = [], [], []
            for li in range(n_lights):
                so = geom["so"][li]
                sd = geom["sd"][li]
                dist = geom["dist"][li]

                def occ_body(kind, li=li, so=so, sd=sd, dist=dist):
                    load = loaders[2] if kind == "tri" else loaders[3]

                    def body(i, acc):
                        _, vjp = jax.vjp(
                            lambda tb, s_, d_, q_, cd: _occ_term(
                                tb, s_, d_, q_, with_const(cd), kind
                            ),
                            load(li, i), so, sd, dist, ctx_diff,
                        )
                        gtb, gso, gsd, gdist, gcd = vjp(g_logvis[li])
                        store_rows(("sh", kind, li), i, gtb, None)
                        return tree_add(acc, (gcd, gso, gsd, gdist))

                    return body

                zero = jnp.zeros(shape, jnp.float32)
                acc = (gctx, (zero,) * 3, (zero,) * 3, zero)
                acc = jax.lax.fori_loop(0, counts[2][li][0], occ_body("tri"),
                                        acc)
                acc = jax.lax.fori_loop(0, counts[2][li][1], occ_body("sph"),
                                        acc)
                gctx = acc[0]
                g_so.append(acc[1])
                g_sd.append(acc[2])
                g_dist.append(acc[3])
            g_geom = dict(
                g_geom,
                so=tree_add(g_geom["so"], tuple(g_so)),
                sd=tree_add(g_geom["sd"], tuple(g_sd)),
                dist=tree_add(g_geom["dist"], tuple(g_dist)),
            )
        g_f, gctx_c = geom_vjp(g_geom)
        gctx = tree_add(gctx, split(gctx_c))
    else:
        _, shade_vjp = jax.vjp(lambda f_: _shade_nonagg(f_, shading=shading),
                               f)
        (g_f,) = shade_vjp(g_rgb)
        gctx = jax.tree_util.tree_map(jnp.zeros_like, ctx_diff)

    def cand_body(kind):
        load = loaders[0] if kind == "tri" else loaders[1]

        def body(i, gctx_a):
            tab, alb = load(i)
            _, vjp = jax.vjp(
                lambda tb, al, cd: _contrib(tb, al, with_const(cd), m, kind,
                                            **cfg),
                tab, alb, ctx_diff,
            )
            gtb, gal, gcd = vjp(g_f)
            store_rows(kind, i, gtb, gal)
            return tree_add(gctx_a, gcd)

        return body

    gctx = jax.lax.fori_loop(0, counts[0], cand_body("tri"), gctx)
    gctx = jax.lax.fori_loop(0, counts[1], cand_body("sph"), gctx)
    zero_const = jax.tree_util.tree_map(jnp.zeros_like, ctx_const)
    return builder_vjp({**gctx, **zero_const})


# ---------------------------------------------------------------------------
# Kernels + wrappers
# ---------------------------------------------------------------------------

def _soft_cfg(bins: SoftBins, packed, shading, shadows):
    return dict(
        projective=bins.projective,
        aggregate=shading == "phong" or (shadows and shading == "lambert"),
        shading=shading,
        shadows=shadows,
        n_lights=packed.lights.position.shape[0],
    )


def _n_stored(cfg) -> int:
    """Planes the forward stores for the backward: streaming finals plus
    the per-light log visibility."""
    n = _n_finals(cfg["aggregate"])
    if cfg["aggregate"] and cfg["shadows"]:
        n += cfg["n_lights"]
    return n


def _block_spec(rows: int, ntx: int):
    """Program (t, s) owns image rows [s*rows, +rows) of tile t."""
    n_sub = TILE_H // rows
    return pl.BlockSpec(
        (rows, TILE_W), lambda t, s: ((t // ntx) * n_sub + s, t % ntx)
    )


def _program_setup(params_ref, taus_ref, counts_ref, tables, *, rows, ntx,
                   n_lights, projective):
    """Program ids -> (tile, sub, pv, taus, x, y, counts, loaders)."""
    tile = pl.program_id(0)
    sub = pl.program_id(1)
    tt, ta, st_, sa, tsh, ssh = tables
    ty = tile // ntx
    tx = tile - ty * ntx
    col = jax.lax.broadcasted_iota(jnp.int32, (rows, TILE_W), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (rows, TILE_W), 0)
    x = (tx * TILE_W + col).astype(jnp.float32)
    y = (ty * TILE_H + sub * rows + row).astype(jnp.float32)
    pv = tuple(params_ref[q] for q in range(params_ref.shape[0]))
    counts = (
        counts_ref[tile, 0],
        counts_ref[tile, 1],
        tuple(
            (counts_ref[tile, 2 + 2 * li], counts_ref[tile, 3 + 2 * li])
            for li in range(n_lights)
        ),
    )
    sh_tile = 0 if projective else tile  # pinhole shadow tables are shared
    k_sh_tri = tsh.shape[1] // n_lights
    k_sh_sph = ssh.shape[1] // n_lights
    row16 = lambda ref, t_, i: tuple(ref[t_, i, q] for q in range(16))
    loaders = (
        lambda i: (row16(tt, tile, i), tuple(ta[tile, i, q] for q in range(8))),
        lambda i: (row16(st_, tile, i), tuple(sa[tile, i, q] for q in range(8))),
        lambda li, i: row16(tsh, sh_tile, li * k_sh_tri + i),
        lambda li, i: row16(ssh, sh_tile, li * k_sh_sph + i),
    )
    return tile, sub, pv, (taus_ref[0], taus_ref[1]), x, y, counts, loaders


def _soft_fwd_pallas(params, taus, tables, counts, *, nty, ntx, cfg,
                     interpret):
    """-> (r, g, b) planes of the padded frame + the stored planes."""
    rows = FWD_ROWS
    frame = (nty * TILE_H, ntx * TILE_W)
    n_out = 3 + _n_stored(cfg)

    def kernel(params_ref, taus_ref, counts_ref, *refs):
        tables_, outs = refs[:6], refs[6:]
        tile, _, pv, (td, te), x, y, cts, loaders = _program_setup(
            params_ref, taus_ref, counts_ref, tables_, rows=rows, ntx=ntx,
            n_lights=cfg["n_lights"], projective=cfg["projective"],
        )
        empty = (cts[0] + cts[1]) == 0

        # No candidate: the streaming state of an all-miss block (m =
        # NEG_BIG, sums 0, w_bg = 1) and its image, rgb = 0.
        @pl.when(empty)
        def _():
            for q, ref in enumerate(outs):
                fill = NEG_BIG if q == 3 else 0.0
                ref[...] = jnp.full((rows, TILE_W), fill, jnp.float32)

        @pl.when(jnp.logical_not(empty))
        def _():
            ctx = _ctx_make(pv, td, te, x, y, projective=cfg["projective"],
                            n_lights=cfg["n_lights"])
            rgb, fin = _tile_forward(ctx, loaders, cts,
                                     shape=(rows, TILE_W), **cfg)
            for ref, v in zip(outs, rgb + fin):
                ref[...] = v

    block = _block_spec(rows, ntx)
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(frame, jnp.float32)] * n_out,
        grid=(nty * ntx, TILE_H // rows),
        in_specs=[pl.BlockSpec()] * 9,
        out_specs=[block] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=FWD_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="octrt_soft_fwd",
    )(params, taus, counts, *tables)


def _soft_bwd_pallas(params, taus, tables, counts, g_planes, stored, *, nty,
                     ntx, cfg, interpret):
    """Per-(tile, block) gradient slots: table rows, params, taus."""
    rows = BWD_ROWS
    n_tiles, n_sub = nty * ntx, TILE_H // rows
    n_params = params.shape[0]
    n_lights = cfg["n_lights"]
    n_stored = len(stored)
    grad_shapes = [(n_tiles, n_sub) + t.shape[1:] for t in tables] + [
        (n_tiles, n_sub, n_params), (n_tiles, n_sub, 2),
    ]

    def kernel(params_ref, taus_ref, counts_ref, *refs):
        tables_ = refs[:6]
        g_refs = refs[6:9]
        stored_refs = refs[9:9 + n_stored]
        d_tt, d_ta, d_st, d_sa, d_tsh, d_ssh, d_par, d_tau = refs[9 + n_stored:]
        tile, sub, pv, (td, te), x, y, cts, loaders = _program_setup(
            params_ref, taus_ref, counts_ref, tables_, rows=rows, ntx=ntx,
            n_lights=n_lights, projective=cfg["projective"],
        )
        k_sh = (tables_[4].shape[1] // n_lights,
                tables_[5].shape[1] // n_lights)

        def store_rows(kind, i, g_row, g_alb):
            if isinstance(kind, tuple):      # ("sh", kind, light)
                _, k, li = kind
                ref = d_tsh if k == "tri" else d_ssh
                i = li * k_sh[0 if k == "tri" else 1] + i
            else:
                ref = d_tt if kind == "tri" else d_st
                aref = d_ta if kind == "tri" else d_sa
                for q in range(8):
                    aref[tile, sub, i, q] = g_alb[q]
            for q in range(16):
                ref[tile, sub, i, q] = g_row[q]

        # empty tiles write nothing: the wrapper masks their slots
        @pl.when((cts[0] + cts[1]) > 0)
        def _():
            g_rgb = tuple(ref[...] for ref in g_refs)
            st = tuple(ref[...] for ref in stored_refs)
            gpv, gtd, gte = _tile_backward(
                pv, td, te, x, y, g_rgb, loaders, cts, st, store_rows,
                shape=(rows, TILE_W), **cfg,
            )
            for q in range(n_params):
                d_par[tile, sub, q] = gpv[q]
            d_tau[tile, sub, 0] = gtd
            d_tau[tile, sub, 1] = gte

    block = _block_spec(rows, ntx)
    grads = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(s, jnp.float32) for s in grad_shapes],
        grid=(n_tiles, n_sub),
        in_specs=[pl.BlockSpec()] * 9 + [block] * (3 + n_stored),
        out_specs=[pl.BlockSpec()] * len(grad_shapes),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=BWD_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="octrt_soft_bwd",
    )(params, taus, counts, *tables, *g_planes, *stored)
    return _reduce_slots(grads, counts, n_lights, cfg["projective"])


def _reduce_slots(grads, counts, n_lights, projective):
    """Sum the per-block gradient slots of each tile, keeping only the
    slots the kernel wrote (rows below the candidate counts of non-empty
    tiles; the rest is unwritten memory)."""
    d_tt, d_ta, d_st, d_sa, d_tsh, d_ssh, d_par, d_tau = grads
    live = (counts[:, 0] + counts[:, 1]) > 0

    def rows_sum(g, cnt):
        valid = (jnp.arange(g.shape[2])[None, :] < cnt[:, None]) & live[:, None]
        return jnp.where(valid[:, None, :, None], g, 0.0).sum(1)

    def sh_sum(g, col):
        k = g.shape[2] // n_lights
        cnt = counts[:, col::2][:, :n_lights]            # (n_tiles, L)
        idx = jnp.arange(g.shape[2])
        valid = (idx[None, :] % k < jnp.repeat(cnt, k, axis=1)) & live[:, None]
        out = jnp.where(valid[:, None, :, None], g, 0.0).sum(1)
        return out.sum(0, keepdims=True) if projective else out

    par_live = lambda g: jnp.where(live[:, None, None], g, 0.0).sum((0, 1))
    return (
        rows_sum(d_tt, counts[:, 0]), rows_sum(d_ta, counts[:, 0]),
        rows_sum(d_st, counts[:, 1]), rows_sum(d_sa, counts[:, 1]),
        sh_sum(d_tsh, 2), sh_sum(d_ssh, 3),
        par_live(d_par), par_live(d_tau),
    )


def _frame_rgba(planes, height, width):
    r, g, b = (p[:height, :width] for p in planes)
    return jnp.stack([r, g, b, jnp.full_like(r, 255.0)], axis=-1)


def _g_planes(g, nty, ntx):
    """(H, W, 4) cotangent -> zero-padded r, g, b planes of the frame."""
    h, w = g.shape[:2]
    pad = ((0, nty * TILE_H - h), (0, ntx * TILE_W - w))
    return tuple(jnp.pad(g[..., q].astype(jnp.float32), pad) for q in range(3))


# --- custom VJP --------------------------------------------------------------

def _make_bins(packed, camera, tau_e, height, width, shadows, k, shadow_k):
    return _bin_soft(
        jax.lax.stop_gradient(packed), jax.lax.stop_gradient(tau_e),
        jax.lax.stop_gradient(camera),
        height=height, width=width, k=k, shadows=shadows, shadow_k=shadow_k,
    )


def _dense(packed, camera, tau_d, tau_e, height, width, shading, shadows):
    """The overflow fallback: the dense XLA twin."""
    return render_soft_jit(
        packed.unpack(), camera, tau_d, tau_e, height=height, width=width,
        shading=shading, shadows=shadows,
    )


def _soft_fwd_core(packed, camera, tau_d, tau_e, height, width, shading,
                   shadows, interpret, k, shadow_k):
    bins = _make_bins(packed, camera, tau_e, height, width, shadows, k,
                      shadow_k)
    cfg = _soft_cfg(bins, packed, shading, shadows)
    frame = (bins.nty * TILE_H, bins.ntx * TILE_W)
    n_stored = _n_stored(cfg)

    def tiled(args):
        p, c, td, te = args
        tables = _gather_soft_tables(p, c, te, bins)
        params = _camera_params(c, p.lights)
        taus = jnp.stack([td, te]).astype(jnp.float32)
        out = _soft_fwd_pallas(
            params, taus, tables, bins.counts, nty=bins.nty, ntx=bins.ntx,
            cfg=cfg, interpret=interpret,
        )
        return _frame_rgba(out[:3], height, width), tuple(out[3:])

    def overflow(args):
        img = _dense(*args, height, width, shading, shadows)
        # shape-matched dummies: the overflow backward differentiates the
        # dense twin itself and never reads them
        return img, tuple(jnp.zeros(frame, jnp.float32)
                          for _ in range(n_stored))

    img, stored = jax.lax.cond(
        bins.overflow, overflow, tiled, (packed, camera, tau_d, tau_e)
    )
    return img, bins, stored


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9, 10))
def _soft_tiled_core(packed, camera, tau_d, tau_e, height, width, shading,
                     shadows, interpret, k, shadow_k):
    img, _, _ = _soft_fwd_core(packed, camera, tau_d, tau_e, height, width,
                               shading, shadows, interpret, k, shadow_k)
    return img


def _soft_tiled_vjp_fwd(packed, camera, tau_d, tau_e, height, width, shading,
                        shadows, interpret, k, shadow_k):
    img, bins, stored = _soft_fwd_core(
        packed, camera, tau_d, tau_e, height, width, shading, shadows,
        interpret, k, shadow_k,
    )
    return img, (packed, camera, tau_d, tau_e, bins, stored)


def _soft_tiled_vjp_bwd(height, width, shading, shadows, interpret, k,
                        shadow_k, res, g):
    packed, camera, tau_d, tau_e, bins, stored = res
    cfg = _soft_cfg(bins, packed, shading, shadows)

    def tiled(args):
        p, c, td, te, g_, st = args

        def prep(p_, c_, te_):
            return _gather_soft_tables(p_, c_, te_, bins) + (
                _camera_params(c_, p_.lights),
            )

        outs, prep_vjp = jax.vjp(prep, p, c, te)
        tables, params = outs[:6], outs[6]
        taus = jnp.stack([td, te]).astype(jnp.float32)
        grads = _soft_bwd_pallas(
            params, taus, tables, bins.counts,
            _g_planes(g_, bins.nty, bins.ntx), st,
            nty=bins.nty, ntx=bins.ntx, cfg=cfg, interpret=interpret,
        )
        d_packed, d_camera, d_te = prep_vjp(tuple(grads[:7]))
        return d_packed, d_camera, grads[7][0], grads[7][1] + d_te

    def overflow(args):
        p, c, td, te, g_, _ = args
        _, vjp = jax.vjp(
            lambda *a: _dense(*a, height, width, shading, shadows),
            p, c, td, te,
        )
        return vjp(g_)

    return jax.lax.cond(
        bins.overflow, overflow, tiled,
        (packed, camera, tau_d, tau_e, g, stored),
    )


_soft_tiled_core.defvjp(_soft_tiled_vjp_fwd, _soft_tiled_vjp_bwd)


def render_soft_tiled(
    scene,
    camera: Camera,
    config: RenderConfig,
    interpret: Optional[bool] = None,
) -> jax.Array:
    """Tiled+culled soft differentiable render, Pallas fwd AND bwd.

    Covers both camera families: shared-direction (affine soft
    coefficients) and shared-origin pinhole (projective coefficients; full
    shared shadow-occluder tables, since no screen-space corridor bounds
    pinhole shadow rays). Any tile exceeding config.cull_k / shadow_cull_k
    candidates falls back to the dense XLA twin for the frame (lax.cond —
    never silently wrong). `interpret` (default: config.interpret) runs the
    kernels in the Pallas interpreter; without it they need a GPU. Output
    float32 (H, W, 4), 0..255 domain."""
    if interpret is None:
        interpret = config.interpret
    check_kernel_platform(interpret)
    packed = scene.pack() if hasattr(scene, "pack") else scene
    return _soft_tiled_core(
        packed,
        camera,
        jnp.float32(config.tau_depth),
        jnp.float32(config.tau_edge),
        config.height,
        config.width,
        config.shading,
        config.shadows,
        interpret,
        config.cull_k,
        config.shadow_cull_k,
    )
