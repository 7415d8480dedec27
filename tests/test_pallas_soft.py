"""Pallas soft-kernel cross-check vs the jnp soft renderer + grad flow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera, pinhole_camera
from opencl_ray_tracer.diff import render_soft
from opencl_ray_tracer.kernels.soft_tiled import render_soft_tiled
from opencl_ray_tracer.scene import Scene, random_scene

W, H = 128, 64


def cfg(shading="lambert", **kw):
    base = dict(
        width=W, height=H, shading=shading, soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
    )
    base.update(kw)
    return RenderConfig(**base)


def small_scene():
    from opencl_ray_tracer.scene import Cube

    cube = Cube([0.2, 0.8, 0.3, 255.0])
    cube.scale(9.0).rotate((0.4, 0.3, 0.2)).translate((90.0, 20.0, -35.0))
    return Scene.build(
        sphere_origin=[[30.0, 30.0, -40.0], [64.0, 40.0, -60.0]],
        sphere_radius=[14.0, 18.0],
        sphere_colour=[[1.0, 0.2, 0.2, 255.0], [0.2, 0.2, 1.0, 255.0]],
        cubes=[cube],
    )


@pytest.mark.parametrize("shading", ["legacy", "lambert"])
def test_soft_pallas_matches_jnp(shading):
    scene = small_scene()
    cam = legacy_ortho_camera()
    c = cfg(shading=shading)
    ref = np.asarray(render_soft(scene, cam, c))
    pal = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    assert pal.shape == ref.shape
    err = np.abs(ref - pal)
    assert np.percentile(err, 99.9) < 0.1, f"p99.9 err {np.percentile(err, 99.9)}"
    assert err.max() < 1.0, f"max err {err.max()}"


def test_soft_pallas_random_scene():
    scene = random_scene(12, 6, seed=2, bounds=(120.0, 60.0))
    cam = legacy_ortho_camera()
    c = cfg("lambert")
    ref = np.asarray(render_soft(scene, cam, c))
    pal = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    assert np.abs(ref - pal).max() < 1.0


def test_soft_pallas_pinhole():
    scene = small_scene()
    cam = pinhole_camera(
        position=(64.0, 32.0, 60.0), look_at=(64.0, 32.0, -40.0),
        fov_degrees=70.0, width=W, height=H,
    )
    c = cfg("lambert")
    ref = np.asarray(render_soft(scene, cam, c))
    pal = np.asarray(render_soft_tiled(scene, cam, c, interpret=True))
    assert np.abs(ref - pal).max() < 1.0
    assert (pal[..., :3] > 1.0).any()  # scene visible


def test_soft_pallas_gradients_match_jnp():
    """custom_vjp backward == grads of the jnp twin."""
    scene = small_scene()
    cam = legacy_ortho_camera()
    c = cfg("lambert")
    target = jnp.zeros((H, W, 4))

    def loss_pallas(s):
        img = render_soft_tiled(s, cam, c, interpret=True)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    def loss_jnp(s):
        img = render_soft(s, cam, c)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    g_p = jax.grad(loss_pallas)(scene)
    g_j = jax.grad(loss_jnp)(scene)
    for name in ("sphere_origin", "sphere_radius", "sphere_colour", "tri_verts"):
        a = np.asarray(getattr(g_p, name))
        b = np.asarray(getattr(g_j, name))
        assert np.any(a != 0), f"zero grad for {name}"
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-5, err_msg=name)
