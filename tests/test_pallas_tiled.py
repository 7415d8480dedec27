"""Tiled+culled kernel cross-check vs the CPU oracle (interpret mode)."""

import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
from opencl_ray_tracer.kernels.fwd_tiled import render_tiled
from opencl_ray_tracer.ref import render_reference
from opencl_ray_tracer.scene import random_scene

W, H = 256, 128  # 2x2 tiles of 128x64


def frac_identical(a, b):
    return np.all(np.asarray(a) == np.asarray(b), axis=-1).mean()


@pytest.mark.parametrize("scene_fix", ["scene1", "scene2"])
def test_tiled_legacy_parity(scene_fix, request):
    scene = request.getfixturevalue(scene_fix)
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    cam = legacy_ortho_camera()
    oracle = render_reference(scene, cam, cfg)
    tiled = render_tiled(scene, cam, cfg, interpret=True)
    assert tiled.shape == (H, W, 4)
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"


def test_tiled_culling_exhaustive_vs_oracle(scene3_small):
    """Random scene: culled candidate lists must not drop any visible prim."""
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    cam = legacy_ortho_camera()
    oracle = render_reference(scene3_small, cam, cfg)
    tiled = render_tiled(scene3_small, cam, cfg, interpret=True)
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"


def test_tiled_overflow_escalates_k_eagerly():
    """More overlapping prims in one tile than K: the eager wrapper must
    re-bin with doubled K (no 10x brute
    cliff) and stay correct."""
    import jax

    from opencl_ray_tracer.kernels.fwd_tiled import bin_scene

    # 40 spheres piled on the same spot -> every tile they cover exceeds K=32
    scene = random_scene(40, 0, seed=9, bounds=(60.0, 40.0))
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    cam = legacy_ortho_camera()
    packed = scene.pack()
    assert bool(
        bin_scene(packed, height=H, width=W, k=cfg.cull_k).overflow
    ), "scene must actually overflow the default K"
    # escalated K fits all candidates
    assert not bool(
        bin_scene(packed, height=H, width=W, k=48).overflow
    )
    oracle = render_reference(scene, cam, cfg)
    tiled = render_tiled(scene, cam, cfg, interpret=True)  # eager: escalation path
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"

    # under jit the overflow flag is traced: the lax.cond brute fallback
    # must produce the same image
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled_packed

    jitted = jax.jit(
        lambda p: render_tiled_packed(p, cam, cfg, interpret=True)
    )(packed)
    frac = frac_identical(jitted, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical (cond path)"


@pytest.mark.parametrize("shading,shadows", [("lambert", False), ("phong", True)])
def test_tiled_shaded_parity(scene1, shading, shadows):
    cfg = RenderConfig(
        width=W, height=H, shading=shading, shadows=shadows,
        framebuffer_dtype="float",
    )
    cam = legacy_ortho_camera()
    oracle = np.asarray(render_reference(scene1, cam, cfg))
    tiled = np.asarray(render_tiled(scene1, cam, cfg, interpret=True))
    diff = np.abs(oracle - tiled).max(axis=-1)
    close = (diff < 0.5).mean()
    assert close > 0.995, f"only {close:.4%} of pixels within 0.5/255"


def test_tiled_non_aligned_resolution(scene1):
    cfg = RenderConfig(width=200, height=100, shading="legacy")
    cam = legacy_ortho_camera()
    oracle = render_reference(scene1, cam, cfg)
    tiled = render_tiled(scene1, cam, cfg, interpret=True)
    assert tiled.shape == (100, 200, 4)
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995


def test_tiled_spheres_only_and_tris_only():
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    s_only = random_scene(10, 0, seed=5, bounds=(250.0, 120.0))
    assert frac_identical(
        render_tiled(s_only, cam, cfg, interpret=True), render_reference(s_only, cam, cfg)
    ) > 0.995
    t_only = random_scene(0, 10, seed=6, bounds=(250.0, 120.0))
    assert frac_identical(
        render_tiled(t_only, cam, cfg, interpret=True), render_reference(t_only, cam, cfg)
    ) > 0.995
