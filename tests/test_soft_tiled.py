"""Tiled+culled soft kernel cross-checks (kernels/soft_tiled.py), in the
Pallas interpreter.

Oracle: the independent dense jnp twin (diff/soft.py), which is also the
kernels' overflow fallback. This file holds the phong+shadow gradient
contract, the overflow->dense lax.cond fallback, the stored-finals
backward in each finals layout, and the saturation behaviour pin."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
from opencl_ray_tracer.diff import render_soft
from opencl_ray_tracer.diff.soft import render_soft_jit
from opencl_ray_tracer.kernels.soft_tiled import render_soft_tiled
from opencl_ray_tracer.scene import random_scene

W, H = 256, 128  # 2x2 tiles


def cfg(shading="phong", shadows=True, **kw):
    base = dict(
        width=W, height=H, shading=shading, shadows=shadows, soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
    )
    base.update(kw)
    return RenderConfig(**base)


def brute(scene, cam, c):
    """The dense jnp twin on the packed scene's primitives."""
    packed = scene.pack() if hasattr(scene, "pack") else scene
    return render_soft_jit(
        packed.unpack(), cam, jnp.float32(c.tau_depth),
        jnp.float32(c.tau_edge), height=c.height, width=c.width,
        shading=c.shading, shadows=c.shadows,
    )


@pytest.fixture(scope="module")
def scene():
    return random_scene(5, 3, seed=4, bounds=(250.0, 120.0))


@pytest.mark.parametrize(
    "shading,shadows",
    [("legacy", False), ("lambert", False), ("lambert", True), ("phong", True)],
)
def test_tiled_soft_matches_brute(scene, shading, shadows):
    cam = legacy_ortho_camera()
    c = cfg(shading=shading, shadows=shadows)
    t = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    b = np.asarray(brute(scene, cam, c))
    assert np.abs(t - b).max() < 0.05, np.abs(t - b).max()


def test_tiled_soft_matches_twin_phong_shadows(scene):
    cam = legacy_ortho_camera()
    c = cfg("phong", True)
    t = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    ref = np.asarray(render_soft(scene, cam, c))
    err = np.abs(t - ref)
    assert np.percentile(err, 99.9) < 0.1, np.percentile(err, 99.9)
    assert err.max() < 1.0, err.max()


def test_tiled_soft_grads_match_brute_phong_shadows(scene):
    """Tiled backward == the dense twin's backward, including
    light-position grads THROUGH soft shadow visibility."""
    cam = legacy_ortho_camera()
    c = cfg("phong", True)
    packed = scene.pack()

    def loss_tiled(p):
        img = render_soft_tiled(p, cam, c, interpret=True)
        return jnp.mean(img[..., :3] ** 2)

    def loss_brute(p):
        return jnp.mean(brute_packed(p)[..., :3] ** 2)

    def brute_packed(p):
        return brute(p, cam, c)

    gt = jax.grad(loss_tiled)(packed)
    gb = jax.grad(loss_brute)(packed)
    for name in ("sph_origin", "sph_radius", "sph_colour", "tri_v0", "tri_e1"):
        a, b = np.asarray(getattr(gt, name)), np.asarray(getattr(gb, name))
        assert np.any(a != 0), f"zero grad for {name}"
        assert np.all(np.isfinite(a)), f"non-finite tiled grad for {name}"
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3, err_msg=name)
    a = np.asarray(gt.lights.position)
    b = np.asarray(gb.lights.position)
    assert np.any(a != 0), "no light-position grads through shadows"
    np.testing.assert_allclose(
        a / (np.abs(b).max() + 1e-12), b / (np.abs(b).max() + 1e-12), atol=1e-3
    )


def test_tiled_soft_overflow_falls_back_to_brute():
    """More overlapping prims than cull_k: the lax.cond must take the dense
    twin for BOTH forward and backward, staying correct and differentiable."""
    pile = random_scene(40, 0, seed=9, bounds=(60.0, 40.0))
    cam = legacy_ortho_camera()
    c = cfg("lambert", False)
    packed = pile.pack()
    t = np.asarray(render_soft_tiled(pile, cam, c, interpret=True))
    b = np.asarray(brute(pile, cam, c))
    np.testing.assert_allclose(t, b, atol=1e-4)

    g = jax.grad(
        lambda p: jnp.mean(
            render_soft_tiled(p, cam, c, interpret=True)[..., :3] ** 2
        )
    )(packed)
    assert np.all(np.isfinite(np.asarray(g.sph_origin)))
    assert np.any(np.asarray(g.sph_origin) != 0)


def pinhole_cam():
    from opencl_ray_tracer import pinhole_camera

    return pinhole_camera(
        position=(128.0, 64.0, 200.0), look_at=(128.0, 64.0, -60.0),
        fov_degrees=65.0, width=W, height=H,
    )


def brute_pinhole(packed, cam, c):
    return brute(packed, cam, c)


@pytest.mark.parametrize(
    "shading,shadows", [("lambert", False), ("phong", True)]
)
def test_projective_tiled_soft_matches_brute(scene, shading, shadows):
    """Pinhole camera through the projective tiled soft path == the dense
    twin (which evaluates geometric Möller–Trumbore on normalized dirs)."""
    cam = pinhole_cam()
    c = cfg(shading=shading, shadows=shadows)
    t = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    b = np.asarray(brute_pinhole(scene.pack(), cam, c))
    assert (t[..., :3] > 1.0).any(), "pinhole sees nothing"
    err = np.abs(t - b)
    assert np.percentile(err, 99.9) < 0.1, np.percentile(err, 99.9)
    assert err.max() < 1.0, err.max()


@pytest.mark.parametrize(
    "shading,shadows,camera",
    [
        ("phong", True, "ortho"),      # aggregate finals layout
        ("lambert", False, "ortho"),   # per-primitive-shading layout
        ("phong", True, "pinhole"),    # projective + shared shadow tables
    ],
)
def test_stored_finals_bwd_grads_match_recompute(
    scene, shading, shadows, camera
):
    """The backward reads the streaming finals the forward stored; its
    gradients must equal those of the dense twin, whose autodiff
    recomputes everything, in every finals layout."""
    cam = pinhole_cam() if camera == "pinhole" else legacy_ortho_camera()
    c = cfg(shading, shadows)
    packed = scene.pack()

    def loss(fn):
        return lambda p: jnp.mean(fn(p)[..., :3] ** 2)

    g_fin = jax.grad(loss(
        lambda p: render_soft_tiled(p, cam, c, interpret=True)))(packed)
    g_rec = jax.grad(loss(lambda p: brute(p, cam, c)))(packed)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_fin), jax.tree_util.tree_leaves(g_rec)
    ):
        if a.size:
            scale = np.abs(np.asarray(b)).max() + 1e-12
            np.testing.assert_allclose(
                np.asarray(a) / scale, np.asarray(b) / scale, atol=1e-3
            )


def test_stored_finals_fwd_unchanged(scene):
    """The custom_vjp's primal and the forward jax.vjp runs (which keeps
    the stored planes as residuals) give the same image."""
    cam = legacy_ortho_camera()
    c = cfg("phong", True)
    base = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    img2, _ = jax.vjp(
        lambda p: render_soft_tiled(p, cam, c, interpret=True), scene.pack()
    )
    np.testing.assert_allclose(np.asarray(img2), base, atol=1e-4)


def test_projective_tiled_soft_grads_match_brute(scene):
    cam = pinhole_cam()
    c = cfg("phong", True)
    packed = scene.pack()

    gt = jax.grad(lambda p: jnp.mean(
        render_soft_tiled(p, cam, c, interpret=True)[..., :3] ** 2
    ))(packed)
    gb = jax.grad(lambda p: jnp.mean(
        brute_pinhole(p, cam, c)[..., :3] ** 2
    ))(packed)
    for name in ("sph_origin", "sph_radius", "tri_v0", "tri_e1"):
        a, b = np.asarray(getattr(gt, name)), np.asarray(getattr(gb, name))
        assert np.any(a != 0), f"zero grad for {name}"
        assert np.all(np.isfinite(a)), f"non-finite grad for {name}"
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3,
                                   err_msg=name)
    a = np.asarray(gt.lights.position)
    b = np.asarray(gb.lights.position)
    assert np.any(a != 0)
    np.testing.assert_allclose(
        a / (np.abs(b).max() + 1e-12), b / (np.abs(b).max() + 1e-12),
        atol=2e-3,
    )


def test_tiled_soft_saturation_pin(scene):
    """Saturated pixels: forward values clip identically in kernel and twin
    (both clip POST-aggregation), and gradients through saturated pixels are
    zero in both — a past twin-divergence, pinned."""
    hot = dataclasses.replace(
        scene,
        lights=dataclasses.replace(
            scene.lights, intensity=scene.lights.intensity * 50.0
        ),
    )
    cam = legacy_ortho_camera()
    c = cfg("phong", True)
    t = np.asarray(render_soft_tiled(hot, cam, c, interpret=True))
    ref = np.asarray(render_soft(hot, cam, c))
    assert (t[..., :3] == 255.0).mean() > 0.02, "scene not actually saturated"
    err = np.abs(t - ref)
    assert np.percentile(err, 99.9) < 0.1, np.percentile(err, 99.9)

    def loss(fn, s):
        img = fn(s)
        return jnp.mean(img[..., :3] ** 2)

    g_t = jax.grad(lambda s: loss(
        lambda s_: render_soft_tiled(s_, cam, c, interpret=True), s
    ))(hot)
    g_j = jax.grad(lambda s: loss(lambda s_: render_soft(s_, cam, c), s))(hot)
    for name in ("sphere_origin", "lights",):
        a = np.asarray(jax.tree_util.tree_leaves(getattr(g_t, name))[0])
        b = np.asarray(jax.tree_util.tree_leaves(getattr(g_j, name))[0])
        assert np.all(np.isfinite(a)), f"non-finite saturated grad: {name}"
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(
            a / scale, b / scale, atol=2e-2, err_msg=name
        )


def test_tile_soft_T_full_counts_equals_ragged(scene):
    """The ragged-skipping exactness contract of _tile_forward: running
    EVERY candidate slot (counts saturated to the static K) over
    null-padded tables must equal the real ragged-counts path, because
    null slots contribute identically zero. Runs the tile math as plain
    jnp on the densest tile's first pixel block."""
    from opencl_ray_tracer.kernels.prep import _camera_params
    from opencl_ray_tracer.kernels.soft_tiled import (
        FWD_ROWS,
        _bin_soft,
        _ctx_make,
        _gather_soft_tables,
        _soft_cfg,
        _tile_forward,
    )
    from opencl_ray_tracer.kernels.fwd_tiled import TILE_H, TILE_W

    c = cfg()
    cam = legacy_ortho_camera()
    packed = scene.pack()
    tau_e = jnp.float32(c.tau_edge)
    bins = _bin_soft(packed, tau_e, cam, height=H, width=W,
                     k=c.cull_k, shadows=True, shadow_k=c.shadow_cull_k)
    tt, ta, st, sa, tsh, ssh = _gather_soft_tables(packed, cam, tau_e, bins)
    scfg = _soft_cfg(bins, packed, "phong", True)
    n_lights = scfg["n_lights"]
    cnts = np.asarray(bins.counts)
    tile = int(np.argmax(cnts[:, 0] + cnts[:, 1]))  # densest tile
    ty, tx = divmod(tile, bins.ntx)
    y, x = jnp.meshgrid(
        jnp.arange(FWD_ROWS, dtype=jnp.float32) + ty * TILE_H,
        jnp.arange(TILE_W, dtype=jnp.float32) + tx * TILE_W,
        indexing="ij",
    )
    pv = tuple(_camera_params(cam, packed.lights))
    ctx = _ctx_make(pv, jnp.float32(c.tau_depth), tau_e, x, y,
                    projective=False, n_lights=n_lights)
    row = lambda t_, i: tuple(t_[i, q] for q in range(t_.shape[1]))
    kst, kss = tsh.shape[1] // n_lights, ssh.shape[1] // n_lights
    loaders = (
        lambda i: (row(tt[tile], i), row(ta[tile], i)),
        lambda i: (row(st[tile], i), row(sa[tile], i)),
        lambda li, i: row(tsh[tile], li * kst + i),
        lambda li, i: row(ssh[tile], li * kss + i),
    )

    def run(counts):
        rgb, _ = _tile_forward(ctx, loaders, counts,
                               shape=(FWD_ROWS, TILE_W), **scfg)
        return np.stack([np.asarray(v) for v in rgb])

    ragged = run((
        jnp.int32(cnts[tile, 0]),
        jnp.int32(cnts[tile, 1]),
        tuple(
            (jnp.int32(cnts[tile, 2 + 2 * li]),
             jnp.int32(cnts[tile, 3 + 2 * li]))
            for li in range(n_lights)
        ),
    ))
    saturated = run((
        jnp.int32(tt.shape[1]),
        jnp.int32(st.shape[1]),
        tuple((jnp.int32(kst), jnp.int32(kss)) for _ in range(n_lights)),
    ))
    np.testing.assert_allclose(ragged, saturated, atol=1e-2)
