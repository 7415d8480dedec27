"""Dual-backend cross-check: the brute XLA renderer vs the CPU oracle.

This is the framework's version of the reference's F1 CPU<->OpenCL toggle
(SURVEY.md §4.1): same scene, both backends, images must agree. The brute
renderer is reached the way it runs in production: as the overflow
fallback of the tiled renderer (render_tiled_packed with bins whose
overflow flag is set, so its lax.cond takes the XLA branch).

f32 math is identical between the two implementations in exact arithmetic,
but operation ORDER differs (e.g. fused camera FMAs, masked sqrt), so a tiny
fraction of silhouette-edge pixels may flip discretely. Assertions therefore
use fraction-identical for int framebuffers + allclose on the float path away
from edges.
"""

import dataclasses


import jax.numpy as jnp
import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera, pinhole_camera
from opencl_ray_tracer.kernels.fwd_tiled import bin_scene, render_tiled_packed
from opencl_ray_tracer.ref import render_reference
from opencl_ray_tracer.scene import random_scene

W, H = 256, 128  # small but multi-tile (2x2 tiles of 128x64)


def render_pallas(scene, cam, cfg):
    """The tiled renderer's overflow branch: the brute XLA renderer."""
    packed = scene.pack()
    bins = bin_scene(packed, height=cfg.height, width=cfg.width,
                     k=cfg.cull_k, shadows=cfg.shadows,
                     shadow_k=cfg.shadow_cull_k,
                     camera=cam if cam.normalize else None)
    bins = dataclasses.replace(bins, overflow=jnp.bool_(True))
    return render_tiled_packed(packed, cam, cfg, interpret=True, bins=bins)


def frac_identical(a, b):
    return np.all(np.asarray(a) == np.asarray(b), axis=-1).mean()


@pytest.mark.parametrize("scene_fix", ["scene1", "scene2"])
def test_legacy_parity(scene_fix, request):
    scene = request.getfixturevalue(scene_fix)
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    cam = legacy_ortho_camera()
    oracle = render_reference(scene, cam, cfg)
    pallas = render_pallas(scene, cam, cfg)
    assert pallas.shape == (H, W, 4) and np.asarray(pallas).dtype == np.int32
    frac = frac_identical(pallas, oracle)
    assert frac > 0.999, f"only {frac:.4%} identical"


def test_legacy_parity_stress(scene3_small):
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    cam = legacy_ortho_camera()
    oracle = render_reference(scene3_small, cam, cfg)
    pallas = render_pallas(scene3_small, cam, cfg)
    frac = frac_identical(pallas, oracle)
    assert frac > 0.999, f"only {frac:.4%} identical"


@pytest.mark.parametrize("shading,shadows", [("lambert", False), ("phong", True)])
def test_shaded_parity(scene1, shading, shadows):
    cfg = RenderConfig(
        width=W, height=H, shading=shading, shadows=shadows,
        framebuffer_dtype="float",
    )
    cam = legacy_ortho_camera()
    oracle = np.asarray(render_reference(scene1, cam, cfg))
    pallas = np.asarray(render_pallas(scene1, cam, cfg))
    diff = np.abs(oracle - pallas).max(axis=-1)
    # away from discrete edge flips, values must agree tightly (the
    # reference's own two backends disagree on exactly this class of
    # pixel, MainState.cpp:257 vs rayTracer.cl:37).
    close = (diff < 0.5).mean()
    assert close > 0.998, f"only {close:.4%} of pixels within 0.5/255"


def test_pinhole_parity(scene1):
    cam = pinhole_camera(
        position=(320.0, 240.0, 300.0),
        look_at=(320.0, 240.0, -85.0),
        fov_degrees=60.0,
        width=W,
        height=H,
    )
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    oracle = render_reference(scene1, cam, cfg)
    pallas = render_pallas(scene1, cam, cfg)
    frac = frac_identical(pallas, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"
    # pinhole actually sees the scene
    assert np.any(np.asarray(pallas)[..., :3] != 0)


def test_non_tile_aligned_resolution(scene1):
    """Image not a multiple of the tile or of the XLA row chunk: the
    padding paths."""
    cfg = RenderConfig(width=100, height=70, shading="legacy")
    cam = legacy_ortho_camera()
    oracle = render_reference(scene1, cam, cfg)
    pallas = render_pallas(scene1, cam, cfg)
    assert pallas.shape == (70, 100, 4)
    frac = frac_identical(pallas, oracle)
    # Small image => triangle-seam pixels (face diagonals, where u+v==1 up
    # to f32 rounding) weigh more. The reference's own two backends disagree
    # on exactly these pixels too (double vs float triangle math,
    # MainState.cpp:257 vs rayTracer.cl:37).
    assert frac > 0.995


def test_spheres_only_and_tris_only():
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=W, height=H, shading="legacy")

    s_only = random_scene(10, 0, seed=5, bounds=(250.0, 120.0))
    assert frac_identical(
        render_pallas(s_only, cam, cfg), render_reference(s_only, cam, cfg)
    ) > 0.999

    t_only = random_scene(0, 10, seed=6, bounds=(250.0, 120.0))
    assert frac_identical(
        render_pallas(t_only, cam, cfg), render_reference(t_only, cam, cfg)
    ) > 0.999
