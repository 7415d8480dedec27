"""Sharding tests on the virtual 8-device CPU mesh (the fake backend for
multi-chip, SURVEY.md §4): sharded render == single-device render, and the
distributed train step's psum'd grads == single-device grads."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
from opencl_ray_tracer.diff import render_soft
from opencl_ray_tracer.models.xla_backend import render_xla
from opencl_ray_tracer.parallel import (
    init_train_state,
    make_mesh,
    make_train_step,
    render_sharded,
    replicate,
    shard_rows,
)

W, H = 128, 64


def test_mesh_has_8_devices(eight_devices):
    mesh = make_mesh(8)
    assert mesh.shape["image"] == 8


def test_sharded_render_matches_unsharded(scene1, eight_devices):
    cfg = RenderConfig(width=W, height=H, shading="legacy", backend="xla")
    cam = legacy_ortho_camera()
    full = np.asarray(render_xla(scene1, cam, cfg))
    mesh = make_mesh(8)
    sharded = render_sharded(scene1, cam, cfg, mesh=mesh)
    assert sharded.shape == (H, W, 4)
    np.testing.assert_array_equal(np.asarray(sharded), full)


def test_sharded_render_is_actually_sharded(scene1, eight_devices):
    cfg = RenderConfig(width=W, height=H, shading="legacy", backend="xla")
    mesh = make_mesh(8)
    out = render_sharded(scene1, legacy_ortho_camera(), cfg, mesh=mesh)
    shardings = {s.device for s in out.addressable_shards}
    assert len(shardings) == 8, "framebuffer should live row-sharded on 8 devices"


def test_sharded_soft_render(scene1, eight_devices):
    cfg = RenderConfig(
        width=W, height=H, shading="lambert", soft=True, framebuffer_dtype="float"
    )
    cam = legacy_ortho_camera()
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    full = np.asarray(render_soft(scene1, cam, cfg))
    np.testing.assert_allclose(sharded, full, atol=1e-2)


def test_train_step_grads_match_single_device(eight_devices):
    from opencl_ray_tracer.scene import Scene

    scene = Scene.build(
        sphere_origin=[[64.0, 32.0, -40.0]],
        sphere_radius=[18.0],
        sphere_colour=[[1.0, 0.2, 0.2, 255.0]],
    )
    cfg = RenderConfig(
        width=W, height=H, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.25,
    )
    cam = legacy_ortho_camera()
    target = jnp.zeros((H, W, 4), jnp.float32)

    # single-device reference grads
    def loss_fn(s):
        img = render_soft(s, cam, cfg)
        d = (img[..., :3] - target[..., :3]) / 255.0
        return jnp.sum(d * d) / (H * W * 3.0)

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(scene)

    mesh = make_mesh(8)
    optimizer = optax.sgd(0.0)  # lr 0: state unchanged, pure grad check
    step = make_train_step(cam, cfg, optimizer, mesh=mesh)
    state = init_train_state(replicate(scene, mesh), optimizer)
    new_state, loss = step(state, shard_rows(target, mesh))

    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # lr=0 => scene unchanged
    np.testing.assert_allclose(
        np.asarray(new_state.scene.sphere_origin),
        np.asarray(scene.sphere_origin),
    )


def test_train_step_reduces_loss(eight_devices):
    from opencl_ray_tracer.scene import Scene

    scene_true = Scene.build(
        sphere_origin=[[64.0, 32.0, -40.0]],
        sphere_radius=[18.0],
        sphere_colour=[[1.0, 0.2, 0.2, 255.0]],
    )
    scene_init = Scene.build(
        sphere_origin=[[70.0, 36.0, -40.0]],
        sphere_radius=[15.0],
        sphere_colour=[[0.8, 0.3, 0.3, 255.0]],
    )
    cfg = RenderConfig(
        width=W, height=H, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
    )
    cam = legacy_ortho_camera()
    target = render_soft(scene_true, cam, cfg)

    mesh = make_mesh(8)
    optimizer = optax.adam(0.3)
    step = make_train_step(cam, cfg, optimizer, mesh=mesh)
    state = init_train_state(replicate(scene_init, mesh), optimizer)
    tgt = shard_rows(target, mesh)

    losses = []
    for _ in range(25):
        state, loss = step(state, tgt)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]


def test_sharded_pallas_render_matches(scene1, eight_devices):
    """The tiled Pallas kernel inside shard_map on the 8-device mesh."""
    cfg = RenderConfig(width=W, height=H, shading="legacy", backend="pallas", interpret=True)
    cam = legacy_ortho_camera()
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    from opencl_ray_tracer.ref import render_reference

    oracle = np.asarray(render_reference(scene1, cam, cfg))
    frac = np.all(sharded == oracle, axis=-1).mean()
    assert frac > 0.995, f"only {frac:.4%} identical"


def test_sharded_tiled_pallas_tall_image(scene1, eight_devices):
    """TILED kernel inside shard_map, image taller than one tile row: each
    shard's bins must use WORLD tile rects (the camera-offset plumbing) —
    catching the off-by-row0 binning failure mode."""
    cfg = RenderConfig(
        width=256, height=128, shading="phong", shadows=True,
        backend="pallas", interpret=True, framebuffer_dtype="float",
    )
    cam = legacy_ortho_camera()
    mesh = make_mesh(8)  # h_local = 16 rows: shards 4-7 are past tile row 0
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled

    full = np.asarray(render_tiled(scene1, cam, cfg, interpret=True))
    # seam pixels may flip (the shard's coefficient math rounds the same
    # rays differently); away from seams values agree tightly
    close = (np.abs(sharded - full).max(axis=-1) < 0.5).mean()
    assert close > 0.995, f"only {close:.4%} of pixels within 0.5/255"
    assert np.any(sharded[64:, :, :3] != 0), "lower shards render nothing"


def test_sharded_pinhole_tiled(scene1, eight_devices):
    """Projective tiled kernel inside shard_map: shard cameras shift d0 by
    row0*ddy, and each shard bins through its own shifted projection."""
    from opencl_ray_tracer import pinhole_camera
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled

    cfg = RenderConfig(width=256, height=128, shading="legacy",
                       backend="pallas", interpret=True)
    cam = pinhole_camera(
        position=(320.0, 240.0, 300.0), look_at=(320.0, 240.0, -85.0),
        fov_degrees=60.0, width=256, height=128,
    )
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    full = np.asarray(render_tiled(scene1, cam, cfg, interpret=True))
    frac = np.all(sharded == full, axis=-1).mean()
    assert frac > 0.995, f"only {frac:.4%} identical"
    assert np.any(sharded[64:, :, :3] != 0), "lower shards render nothing"


def test_sharded_soft_tiled_tall_image(scene1, eight_devices):
    """Tiled SOFT kernel (fwd) inside shard_map with per-shard bins."""
    cfg = RenderConfig(
        width=256, height=128, shading="phong", shadows=True, soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
    )
    cam = legacy_ortho_camera()
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    full = np.asarray(render_soft(scene1, cam, cfg))
    np.testing.assert_allclose(sharded, full, atol=1e-2)
    assert np.any(sharded[64:, :, :3] > 1.0), "lower shards render nothing"


def test_mesh_from_config(eight_devices):
    from opencl_ray_tracer.parallel import mesh_from_config

    assert mesh_from_config(
        RenderConfig(mesh_shape=(4,))
    ).shape["image"] == 4
    # None = all visible devices
    assert mesh_from_config(
        RenderConfig(mesh_shape=None)
    ).shape["image"] == len(jax.devices())
    # 2-tuples build the 2-D (hosts, chips) pod mesh
    m2 = mesh_from_config(RenderConfig(mesh_shape=(2, 4)))
    assert m2.shape["host"] == 2 and m2.shape["image"] == 4
    from opencl_ray_tracer.parallel import mesh_n_shards, mesh_row_axes

    assert mesh_row_axes(m2) == ("host", "image")
    assert mesh_n_shards(m2) == 8
    import pytest

    with pytest.raises(ValueError, match="devices"):
        mesh_from_config(RenderConfig(mesh_shape=(1024,)))
    with pytest.raises(ValueError, match="2 dims"):
        mesh_from_config(RenderConfig(mesh_shape=(2, 2, 2)))


def test_train_step_2d_mesh_matches_flat(eight_devices):
    """The 2-D (processes, devices) mesh with the axis-by-axis psum (within
    a process, then across processes) must produce the same
    loss and the same post-step scene as the flat 8-device mesh — and as
    the single-device grads."""
    from opencl_ray_tracer.parallel import make_mesh_2d
    from opencl_ray_tracer.scene import Scene

    scene = Scene.build(
        sphere_origin=[[64.0, 32.0, -40.0]],
        sphere_radius=[18.0],
        sphere_colour=[[1.0, 0.2, 0.2, 255.0]],
    )
    cfg = RenderConfig(
        width=W, height=H, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.25,
    )
    cam = legacy_ortho_camera()
    target = jnp.zeros((H, W, 4), jnp.float32)

    def run(mesh):
        optimizer = optax.adam(0.1)
        step = make_train_step(cam, cfg, optimizer, mesh=mesh)
        state = init_train_state(replicate(scene, mesh), optimizer)
        state, loss = step(state, shard_rows(target, mesh))
        return float(loss), np.asarray(state.scene.sphere_origin)

    loss_flat, org_flat = run(make_mesh(8))
    loss_2d, org_2d = run(make_mesh_2d(2, 4))
    np.testing.assert_allclose(loss_2d, loss_flat, rtol=1e-6)
    np.testing.assert_allclose(org_2d, org_flat, rtol=1e-5, atol=1e-6)


def test_render_sharded_2d_mesh(scene1, eight_devices):
    """Row-sharded render over the 2-D pod mesh == unsharded."""
    from opencl_ray_tracer.parallel import make_mesh_2d

    cfg = RenderConfig(width=W, height=H, shading="legacy", backend="xla")
    cam = legacy_ortho_camera()
    full = np.asarray(render_xla(scene1, cam, cfg))
    sharded = render_sharded(scene1, cam, cfg, mesh=make_mesh_2d(2, 4))
    np.testing.assert_array_equal(np.asarray(sharded), full)


def test_render_sharded_uses_config_mesh_shape(scene1, eight_devices):
    """No explicit mesh: config.mesh_shape picks the device count."""
    cfg = RenderConfig(width=W, height=H, shading="legacy", backend="xla",
                       mesh_shape=(4,))
    cam = legacy_ortho_camera()
    out = render_sharded(scene1, cam, cfg)
    full = np.asarray(render_xla(scene1, cam, cfg))
    np.testing.assert_array_equal(np.asarray(out), full)


def test_render_sharded_honors_msaa(scene1, eight_devices):
    """Sharded msaa=4 must equal the facade's msaa=4."""
    from opencl_ray_tracer import render

    cfg = RenderConfig(width=W, height=H, shading="phong", shadows=True,
                       framebuffer_dtype="float", msaa=4, backend="pallas", interpret=True)
    cam = legacy_ortho_camera()
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    facade = np.asarray(render(scene1, cam, cfg))
    np.testing.assert_allclose(sharded, facade, atol=1e-3)


def test_render_sharded_packed(scene1, eight_devices):
    """Packed framebuffer through shard_map: (H, W) int32 row shards."""
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled

    cfg = RenderConfig(width=W, height=H, shading="legacy", backend="pallas", interpret=True,
                       framebuffer_dtype="packed")
    cam = legacy_ortho_camera()
    mesh = make_mesh(8)
    sharded = np.asarray(render_sharded(scene1, cam, cfg, mesh=mesh))
    assert sharded.shape == (H, W)
    full = np.asarray(render_tiled(scene1, cam, cfg, interpret=True))
    frac = (sharded == full).mean()
    assert frac > 0.995, f"only {frac:.4%} identical"


def test_train_step_rejects_msaa(eight_devices):
    import pytest

    cfg = RenderConfig(width=W, height=H, shading="lambert", soft=True,
                       framebuffer_dtype="float", msaa=4)
    with pytest.raises(ValueError, match="msaa"):
        make_train_step(
            legacy_ortho_camera(), cfg, optax.adam(1e-2), mesh=make_mesh(8)
        )
