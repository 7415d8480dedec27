"""Soft differentiable renderer (SoftRas-style aggregation).

Hard ray tracing has zero/undefined gradients at silhouette edges and through
the argmin visibility decision (SURVEY.md §7 hard parts). This module makes
the BASELINE.json differentiable contract real:

- every primitive gets a smooth COVERAGE in [0, 1] instead of a binary hit:
  * sphere: sigmoid of the signed silhouette margin (r^2 - d^2)/tau_e,
    gated by a smooth in-front indicator sigmoid(tca/tau_e);
  * triangle: product of sigmoids of the barycentric margins u, v, 1-u-v
    (in units of tau_e scaled to barycentric space);
- visibility is a softmin over depth: primitive weights
    w_i ∝ cov_i * exp(-t_i / tau_d)
  normalized together with a background term, computed with a stabilized
  logsumexp, so w -> one-hot nearest-hit as tau -> 0;
- the pixel colour is the weight-averaged per-primitive shaded colour, so
  d(pixel)/d(center, radius, vertices, colour, light) all exist and are
  smooth.

Pure jnp; differentiable end-to-end with jax.grad. All internals are
PLANAR SoA — (pixels, prims) planes with the xyz components unrolled into
separate arrays, no (..., N, 3)-shaped math. The formulas are identical to
the Pallas kernels'.

Row-chunked with lax.map + jax.checkpoint to bound the (pixels x prims)
intermediates and autodiff residuals. The tiled, culled Pallas form of this
math (streaming softmax, fused backward) lives in kernels/soft_tiled.py;
this dense twin is its oracle and its overflow fallback.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opencl_ray_tracer.camera import Camera, map_row_chunks
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.ops.intersect import EPSILON
from opencl_ray_tracer.ops.shading import LEGACY_FOG_MAX

# Soft-shadow constants. The hard path offsets shadow origins 1e-2 along the
# normal and requires t > 1e-3 (ops/shading.py); the soft gate
# keeps those semantics as tau_e -> 0 but widens the self-occlusion exclusion
# to ~4*tau_e so a surface's own primitive (at t ~ 0) cannot half-shadow it
# through the sigmoid tail.
SHADOW_OFFSET = 1e-2
SHADOW_T_MIN = 1e-3


def _sphere_soft_planar(o, d, scene, tau_e):
    """(P, S) soft depth + coverage + unit-ish normals for spheres.

    o, d: 3-tuples of (P, 1) pixel columns. Returns (t, cov, n) with n a
    3-tuple of (P, S) planes.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    c = scene.sphere_origin  # (S, 3)
    cx, cy, cz = c[:, 0][None, :], c[:, 1][None, :], c[:, 2][None, :]
    r = scene.sphere_radius[None, :]
    lx, ly, lz = cx - ox, cy - oy, cz - oz
    tca = lx * dx + ly * dy + lz * dz
    d2 = lx * lx + ly * ly + lz * lz - tca * tca
    r2 = r * r
    # silhouette margin, normalized by radius so tau_e is in world units
    margin = (r2 - d2) / jnp.maximum(2.0 * r, 1e-6)
    cov = jax.nn.sigmoid(margin / tau_e) * jax.nn.sigmoid(
        tca / jnp.maximum(tau_e, 1e-6)
    )
    # Depth: t = tca - sqrt(r^2 - d^2). The sqrt has an unbounded derivative
    # at the silhouette (and a hard clamp would zero it — autodiff and finite
    # differences then disagree wildly at edge pixels). Replace the clamp
    # with a tau-scaled softplus floor: exact in the interior
    # (q >> beta => softplus ~ identity), smooth and bounded at the edge.
    q = r2 - d2
    beta = jnp.maximum(tau_e, 1e-3) * jnp.maximum(2.0 * r, 1e-6)
    thc = jnp.sqrt(beta * jax.nn.softplus(q / beta) + 1e-12)
    t = tca - thc
    # guarded reciprocal: 1/max(r, eps) has an f32-inf derivative at the
    # zero-radius padded slots, which poisons sph_radius grads with NaN.
    rpos = r > 0
    inv_r = jnp.where(rpos, 1.0 / jnp.where(rpos, r, 1.0), 0.0)
    nx = (ox + t * dx - cx) * inv_r
    ny = (oy + t * dy - cy) * inv_r
    nz = (oz + t * dz - cz) * inv_r
    return t, cov, (nx, ny, nz)


def _tri_soft_planar(o, d, scene, tau_e):
    """(P, T) soft depth + coverage + ray-facing normals for triangles."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0 = scene.tri_verts[:, 0, :]                      # (T, 3)
    e1 = scene.tri_verts[:, 1, :] - v0
    e2 = scene.tri_verts[:, 2, :] - v0
    v0x, v0y, v0z = (v0[:, q][None, :] for q in range(3))
    e1x, e1y, e1z = (e1[:, q][None, :] for q in range(3))
    e2x, e2y, e2z = (e2[:, q][None, :] for q in range(3))

    # pvec = d x e2 (per pixel-prim, unrolled)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = jnp.abs(det) >= EPSILON
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det

    # Edge lengths give the world-per-barycentric scale so tau_e stays in
    # world units across differently sized triangles.
    s1 = jnp.sqrt(jnp.maximum(e1x * e1x + e1y * e1y + e1z * e1z, 0.0))
    s2 = jnp.sqrt(jnp.maximum(e2x * e2x + e2y * e2y + e2z * e2z, 0.0))
    tau_u = tau_e / jnp.maximum(s1, 1e-6)
    tau_v = tau_e / jnp.maximum(s2, 1e-6)
    tau_w = tau_e / jnp.maximum(0.5 * (s1 + s2), 1e-6)
    cov = (
        jax.nn.sigmoid(u / tau_u)
        * jax.nn.sigmoid(v / tau_v)
        * jax.nn.sigmoid((1.0 - u - v) / tau_w)
    )
    cov = jnp.where(det_ok, cov, 0.0)

    # geometric normal, flipped to face the ray per pixel
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    gmag = jnp.sqrt(jnp.maximum(gnx * gnx + gny * gny + gnz * gnz, 1e-40))
    gnx, gny, gnz = gnx / gmag, gny / gmag, gnz / gmag
    ndotd = gnx * dx + gny * dy + gnz * dz
    flip = jnp.where(ndotd > 0, -1.0, 1.0)
    return t, cov, (gnx * flip, gny * flip, gnz * flip)


def _shade_planar(scene, o, d, t, n, albedo, shading):
    """Per-(pixel, prim) shaded RGB planes in the 0..255 domain.

    t: (P, N); n: 3-tuple of (P, N) or (1, N); albedo: (N, 4).
    Returns a 3-tuple of (P, N) planes.
    """
    ar = albedo[:, 0][None, :]
    ag = albedo[:, 1][None, :]
    ab = albedo[:, 2][None, :]
    if shading == "legacy":
        s = 255.0 - (t / LEGACY_FOG_MAX) * 255.0
        return s * ar, s * ag, s * ab
    if shading == "lambert":
        ox, oy, oz = o
        dx, dy, dz = d
        nx, ny, nz = n
        lights = scene.lights
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        diff_r = diff_g = diff_b = 0.0
        for li in range(lights.position.shape[0]):
            lp = lights.position[li]
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            tl2 = jnp.maximum(tlx * tlx + tly * tly + tlz * tlz, 1e-40)
            rinv = jax.lax.rsqrt(tl2)
            ndotl = jnp.maximum((nx * tlx + ny * tly + nz * tlz) * rinv, 0.0)
            w = lights.intensity[li] * ndotl
            lc = lights.colour[li]
            diff_r = diff_r + w * lc[0]
            diff_g = diff_g + w * lc[1]
            diff_b = diff_b + w * lc[2]
        amb = lights.ambient
        # NOTE: clipping happens post-aggregation in trace_soft (linear
        # blending of unclipped radiance), matching the Pallas soft kernel's
        # factored accumulation.
        return (
            ar * (amb + diff_r) * 255.0,
            ag * (amb + diff_g) * 255.0,
            ab * (amb + diff_b) * 255.0,
        )
    raise ValueError(f"soft shading mode {shading!r} not supported (legacy/lambert)")


def _occlusion_logvis(scene, so, ld, dist, tau_e):
    """Log soft visibility of a light along shadow rays.

    so: 3-tuple of (P, 1) shadow origins; ld: 3-tuple of (P, 1) unit
    directions toward the light; dist: (P, 1) distance to the light.
    Returns (P, 1) log prod_j (1 - occ_j): occ_j is primitive j's soft
    coverage of the shadow ray, gated to the open segment
    (SHADOW_T_MIN..dist) with tau_e-temperature sigmoids (the differentiable
    analogue of the hard path's (t > 1e-3) & (t < dist) occlusion test).
    Gradients w.r.t. light position flow through BOTH gates and through the
    silhouette coverage of every occluder — visibility gradients exist.
    """
    tau_g = jnp.maximum(tau_e, 1e-4)
    shift = jnp.maximum(SHADOW_T_MIN, 4.0 * tau_g)
    acc = jnp.zeros_like(dist)
    parts = []
    if scene.num_triangles:
        parts.append(_tri_soft_planar(so, ld, scene, tau_e))
    if scene.num_spheres:
        parts.append(_sphere_soft_planar(so, ld, scene, tau_e))
    for t, cov, _n in parts:
        occ = (
            cov
            * jax.nn.sigmoid((t - shift) / tau_g)
            * jax.nn.sigmoid((dist - t) / tau_g)
        )
        acc = acc + jnp.sum(
            jnp.log1p(-jnp.clip(occ, 0.0, 1.0 - 1e-6)), axis=-1, keepdims=True
        )
    return acc


def _shade_aggregate(scene, o, d, ts, covs, normals, albs, tau_d, tau_e,
                     *, phong: bool, shadows: bool):
    """Shade-after-aggregate: softmax-expected hit point/normal/albedo, then
    ONE shading evaluation per pixel with soft shadows + optional Phong
    specular.

    Per-primitive shading with shadows would be O(pixels x prims x prims);
    aggregating first keeps the shadow pass O(pixels x prims) per light and
    converges to hard phong-at-nearest-hit as tau -> 0 (reference shading
    hook rayTracer.cl:186-196, extended per BASELINE.json config 3).

    ts, covs: (P, N); normals: 3-tuple of (P, N); albs: 3-tuple of (P, N).
    Returns 3-tuple of (P, 1) UNclipped 0..255-domain channels.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    valid = covs > 1e-12
    logit = jnp.where(
        valid, -ts / tau_d + jnp.log(jnp.clip(covs, 1e-12, 1.0)), -1e30
    )
    w = jax.nn.softmax(logit, axis=-1)                           # (P, N)
    w_bg = jnp.exp(
        jnp.sum(
            jnp.log1p(-jnp.clip(covs, 0.0, 1.0 - 1e-6)), axis=-1, keepdims=True
        )
    )
    t_hat = jnp.sum(w * ts, axis=-1, keepdims=True)              # (P, 1)
    nx = jnp.sum(w * normals[0], axis=-1, keepdims=True)
    ny = jnp.sum(w * normals[1], axis=-1, keepdims=True)
    nz = jnp.sum(w * normals[2], axis=-1, keepdims=True)
    ninv = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-20))
    nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
    ar = jnp.sum(w * albs[0], axis=-1, keepdims=True)
    ag = jnp.sum(w * albs[1], axis=-1, keepdims=True)
    ab = jnp.sum(w * albs[2], axis=-1, keepdims=True)
    px = ox + t_hat * dx
    py = oy + t_hat * dy
    pz = oz + t_hat * dz

    vinv = jax.lax.rsqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-20))
    vx, vy, vz = -dx * vinv, -dy * vinv, -dz * vinv

    lights = scene.lights
    zero = jnp.zeros_like(t_hat)
    diff_r, diff_g, diff_b = zero, zero, zero
    spec_r, spec_g, spec_b = zero, zero, zero
    for li in range(lights.position.shape[0]):
        lp = lights.position[li]
        lint = lights.intensity[li]
        lc = lights.colour[li]
        tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
        dist = jnp.sqrt(jnp.maximum(tlx * tlx + tly * tly + tlz * tlz, 1e-20))
        ldx, ldy, ldz = tlx / dist, tly / dist, tlz / dist
        ndotl = jnp.maximum(nx * ldx + ny * ldy + nz * ldz, 0.0)
        if shadows:
            so = (px + SHADOW_OFFSET * nx,
                  py + SHADOW_OFFSET * ny,
                  pz + SHADOW_OFFSET * nz)
            vis = jnp.exp(
                _occlusion_logvis(scene, so, (ldx, ldy, ldz), dist, tau_e)
            )
        else:
            vis = 1.0
        wd = lint * ndotl * vis
        diff_r = diff_r + wd * lc[0]
        diff_g = diff_g + wd * lc[1]
        diff_b = diff_b + wd * lc[2]
        if phong:
            # r = 2(n.l)n - l ; spec = k * max(r.v, 0)^shine (soft through
            # vis, hard ndotl>0 backface gate exactly like the hard path).
            two_ndl = 2.0 * (nx * ldx + ny * ldy + nz * ldz)
            rx = two_ndl * nx - ldx
            ry = two_ndl * ny - ldy
            rz = two_ndl * nz - ldz
            rdotv = jnp.maximum(rx * vx + ry * vy + rz * vz, 0.0)
            ws = (
                lights.spec_strength
                * jnp.exp(lights.shininess * jnp.log(jnp.maximum(rdotv, 1e-20)))
                * lint
                * vis
                * (ndotl > 0.0)
            )
            spec_r = spec_r + ws * lc[0]
            spec_g = spec_g + ws * lc[1]
            spec_b = spec_b + ws * lc[2]

    amb = lights.ambient
    fg = (
        ar * (amb + diff_r) + spec_r,
        ag * (amb + diff_g) + spec_g,
        ab * (amb + diff_b) + spec_b,
    )
    return tuple((1.0 - w_bg) * c * 255.0 for c in fg)


def _soft_aggregate_planar(ts, covs, shade_rgb, tau_d, bg_rgb):
    """Softmin-over-depth aggregation with a coverage-composited background.

    ts, covs: (P, N); shade_rgb: 3-tuple of (P, N); returns 3-tuple (P, 1).

    Two decoupled soft decisions (this matters: folding coverage into the
    depth logits as log(cov) lets a zero-coverage primitive outscore the
    background as tau_d -> 0, tinting every miss pixel):
      1. WHICH primitive is visible: softmax over -t/tau_d among primitives,
         weighted by coverage (log-space);
      2. WHETHER any primitive covers the pixel: w_bg = prod_i (1 - cov_i),
         the smooth probability that no primitive covers it.

    Ranking logits apply a hard VALIDITY cut: primitives with effectively
    zero coverage (cov <= 1e-12 — invisible at this pixel, incl. any padding
    lanes in the Pallas twin) get logit -1e30 and exactly zero weight, so
    they can never outrank a real candidate via the depth term. Depth is
    deliberately UNclamped for valid candidates: a primitive that genuinely
    covers the pixel with negative t wins the softmin, exactly like the
    reference's negative-t-wins quirk in hard mode (rayTracer.cl:74-77,162).
    If every lane is invalid, the softmax goes uniform over junk — harmless,
    because (1 - w_bg) ~ sum(cov) ~ 0 suppresses the whole foreground term.
    """
    valid = covs > 1e-12
    logit = jnp.where(
        valid, -ts / tau_d + jnp.log(jnp.clip(covs, 1e-12, 1.0)), -1e30
    )
    w = jax.nn.softmax(logit, axis=-1)                           # (P, N)
    w_bg = jnp.exp(
        jnp.sum(
            jnp.log1p(-jnp.clip(covs, 0.0, 1.0 - 1e-6)), axis=-1, keepdims=True
        )
    )                                                            # (P, 1)
    out = []
    for c in range(3):
        fg = jnp.sum(w * shade_rgb[c], axis=-1, keepdims=True)
        out.append(w_bg * bg_rgb[c] + (1.0 - w_bg) * fg)
    return out


def trace_soft(scene, o, d, *, shading: str, tau_d, tau_e,
               shadows: bool = False):
    """Soft-trace arbitrary ray bundles -> float RGBA (0..255 domain).

    o: (..., 3) origins; d: (..., 3) or broadcastable directions.

    legacy / lambert-without-shadows shade per primitive then aggregate
    (the SoftRas structure); phong — and lambert with shadows on —
    aggregate the hit attributes first and shade once per pixel so the
    soft-shadow pass stays O(prims), see _shade_aggregate.
    """
    lead = o.shape[:-1]
    d_b = jnp.broadcast_to(d, lead + (3,))
    oc = tuple(o[..., q].reshape(-1, 1) for q in range(3))
    dc = tuple(d_b[..., q].reshape(-1, 1) for q in range(3))

    aggregate_shading = shading == "phong" or (shadows and shading == "lambert")

    parts_t, parts_cov = [], []
    parts_r, parts_g, parts_b = [], [], []          # per-prim shaded rgb
    parts_nx, parts_ny, parts_nz = [], [], []       # per-prim normals
    parts_ar, parts_ag, parts_ab = [], [], []       # per-prim albedo planes

    def add(t, cov, n, colour):
        parts_t.append(t)
        parts_cov.append(cov)
        if aggregate_shading:
            like = jnp.ones_like(t)
            parts_nx.append(n[0] * like)
            parts_ny.append(n[1] * like)
            parts_nz.append(n[2] * like)
            parts_ar.append(colour[:, 0][None, :] * like)
            parts_ag.append(colour[:, 1][None, :] * like)
            parts_ab.append(colour[:, 2][None, :] * like)
        else:
            sr, sg, sb = _shade_planar(scene, oc, dc, t, n, colour, shading)
            parts_r.append(sr)
            parts_g.append(sg)
            parts_b.append(sb)

    if scene.num_triangles:
        t, cov, n = _tri_soft_planar(oc, dc, scene, tau_e)
        add(t, cov, n, scene.tri_colour)
    if scene.num_spheres:
        t, cov, n = _sphere_soft_planar(oc, dc, scene, tau_e)
        add(t, cov, n, scene.sphere_colour)

    ts = jnp.concatenate(parts_t, axis=-1)
    covs = jnp.concatenate(parts_cov, axis=-1)

    if aggregate_shading:
        rgb = _shade_aggregate(
            scene, oc, dc, ts, covs,
            (jnp.concatenate(parts_nx, -1),
             jnp.concatenate(parts_ny, -1),
             jnp.concatenate(parts_nz, -1)),
            (jnp.concatenate(parts_ar, -1),
             jnp.concatenate(parts_ag, -1),
             jnp.concatenate(parts_ab, -1)),
            tau_d, tau_e, phong=shading == "phong", shadows=shadows,
        )
    else:
        shade = (
            jnp.concatenate(parts_r, axis=-1),
            jnp.concatenate(parts_g, axis=-1),
            jnp.concatenate(parts_b, axis=-1),
        )
        rgb = _soft_aggregate_planar(ts, covs, shade, tau_d, (0.0, 0.0, 0.0))

    rgb = jnp.concatenate(rgb, axis=-1)                          # (P, 3)
    if shading != "legacy":
        rgb = jnp.clip(rgb, 0.0, 255.0)
    alpha = jnp.full(rgb.shape[:-1] + (1,), 255.0, jnp.float32)
    return jnp.concatenate([rgb, alpha], axis=-1).reshape(lead + (4,))


@functools.partial(
    jax.jit,
    static_argnames=(
        "height", "width", "shading", "shadows", "row_chunk", "remat"
    ),
)
def render_soft_jit(
    scene,
    camera: Camera,
    tau_d,
    tau_e,
    height: int,
    width: int,
    shading: str = "lambert",
    shadows: bool = False,
    row_chunk: int = 16,
    remat: bool = True,
):
    def do_chunk(args):
        oc, dc = args
        return trace_soft(
            scene, oc, dc, shading=shading, tau_d=tau_d, tau_e=tau_e,
            shadows=shadows,
        )

    if remat:
        # Differentiating through the row-chunk map would otherwise save
        # every (pixels x prims) intermediate of every chunk as an autodiff
        # residual. Rematerialization keeps only the chunk inputs and
        # recomputes the (cheap, compute-bound) forward inside the backward:
        # the classic flash-attention trade of FLOPs for bandwidth.
        do_chunk = jax.checkpoint(do_chunk)

    return map_row_chunks(do_chunk, camera, height, width, row_chunk)


def render_soft(scene, camera: Camera, config: RenderConfig) -> jax.Array:
    """Soft differentiable render -> float32 (H, W, 4), 0..255 domain.

    All three shading modes are differentiable: legacy depth-fog, lambert,
    and phong (with soft shadows when config.shadows) — BASELINE config 3
    ("Phong + hard shadows with backward pass") runs as written."""
    return render_soft_jit(
        scene,
        camera,
        jnp.float32(config.tau_depth),
        jnp.float32(config.tau_edge),
        height=config.height,
        width=config.width,
        shading=config.shading,
        shadows=config.shadows,
    )
