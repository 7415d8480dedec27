"""Segment-hull shadow-culling correctness (kernels/fwd_tiled._bin_prims).

Adversarial property test: for random scenes/lights, any occluder whose
padded AABB is hit by an ACTUAL shadow segment (sampled points in the tile
hit box -> light) must be binned as a candidate for that tile. The hull
test may keep extras (conservative) but must never drop a real occluder —
a false cull would silently brighten shadows."""

import jax
import jax.numpy as jnp
import numpy as np

from opencl_ray_tracer.kernels.fwd_tiled import (
    TILE_H,
    TILE_W,
    _axis_s_interval,
    _bin_prims,
)


def _segment_hits_aabb(p, L, box_lo, box_hi):
    """Does segment p->L intersect AABB [lo, hi]? (slab method)"""
    d = L - p
    t0, t1 = 0.0, 1.0
    for a in range(3):
        if abs(d[a]) < 1e-12:
            if p[a] < box_lo[a] or p[a] > box_hi[a]:
                return False
            continue
        ta = (box_lo[a] - p[a]) / d[a]
        tb = (box_hi[a] - p[a]) / d[a]
        ta, tb = min(ta, tb), max(ta, tb)
        t0, t1 = max(t0, ta), min(t1, tb)
    return t0 <= t1


def test_hull_never_drops_a_real_occluder():
    rng = np.random.default_rng(7)
    nty, ntx = 3, 4
    k = 24  # == P: culling quality, not capacity, is under test
    for trial in range(20):
        P = 24
        # random occluder AABBs scattered over and above the tile grid
        ctr = np.stack(
            [
                rng.uniform(-100, ntx * TILE_W + 100, P),
                rng.uniform(-100, nty * TILE_H + 100, P),
                rng.uniform(-120, 60, P),
            ],
            axis=1,
        ).astype(np.float32)
        half = rng.uniform(2, 40, (P, 3)).astype(np.float32)
        lo, hi = ctr - half, ctr + half
        box = (
            jnp.asarray(lo[:, 0]), jnp.asarray(hi[:, 0]),
            jnp.asarray(lo[:, 1]), jnp.asarray(hi[:, 1]),
        )
        prim_z = (jnp.asarray(lo[:, 2]), jnp.asarray(hi[:, 2]))
        tz0, tz1 = -100.0, -20.0  # hit slab
        light = rng.uniform([-50, -50, -150], [600, 400, 400]).astype(
            np.float32
        )

        idx, valid, count, _ = _bin_prims(
            box, P, nty, ntx, k,
            light_xy=(float(light[0]), float(light[1])),
            light_z=float(light[2]),
            prim_z=prim_z,
            tile_z=(tz0, tz1),
        )
        idx, valid = np.asarray(idx), np.asarray(valid)
        binned = [
            set(idx[t][valid[t]].tolist()) for t in range(nty * ntx)
        ]

        # sample shadow segments: hit points in each tile's hit box
        for t in range(nty * ntx):
            ty, tx = divmod(t, ntx)
            xs = rng.uniform(tx * TILE_W, (tx + 1) * TILE_W, 8)
            ys = rng.uniform(ty * TILE_H, (ty + 1) * TILE_H, 8)
            zs = rng.uniform(tz0, tz1, 8)
            for x, y, z in zip(xs, ys, zs):
                p = np.array([x, y, z], np.float32)
                for j in range(P):
                    if _segment_hits_aabb(p, light, lo[j], hi[j]):
                        assert j in binned[t], (
                            f"trial {trial}: occluder {j} intersects a "
                            f"shadow segment of tile {t} but was culled"
                        )


def test_axis_interval_matches_bruteforce():
    """Per-axis feasible-s interval == brute-force over sampled (s, p)."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        b0, b1 = sorted(rng.uniform(-50, 50, 2))
        L = float(rng.uniform(-100, 100))
        o0, o1 = sorted(rng.uniform(-80, 80, 2))
        lo, hi, ok = _axis_s_interval(
            jnp.float32(b0), jnp.float32(b1), jnp.float32(L),
            jnp.float32(o0), jnp.float32(o1),
        )
        lo, hi, ok = float(lo), float(hi), bool(ok)
        ss = np.linspace(0.0, 1.0, 41)
        feas = []
        for s in ss:
            a0 = (1 - s) * b0 + s * L
            a1 = (1 - s) * b1 + s * L
            feas.append(a0 <= o1 and a1 >= o0)
        pred = [ok and (lo - 1e-4 <= s <= hi + 1e-4) for s in ss]
        assert all(
            p or not f for p, f in zip(pred, feas)
        ), "interval test dropped a feasible s"


def test_corridor_fallback_unchanged():
    """Without z info, _bin_prims keeps the xy-corridor semantics."""
    P = 4
    box = (
        jnp.asarray([0.0, 500.0, 0.0, 500.0]),
        jnp.asarray([30.0, 530.0, 30.0, 530.0]),
        jnp.asarray([0.0, 0.0, 400.0, 400.0]),
        jnp.asarray([30.0, 30.0, 430.0, 430.0]),
    )
    idx, valid, count, _ = _bin_prims(
        box, P, 2, 2, 4, light_xy=(600.0, 600.0)
    )
    # tile 0 corridor to (600,600) covers everything on the diagonal
    assert bool(valid[0].any())
