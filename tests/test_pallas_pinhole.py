"""Pinhole (projective) tiled+culled kernel cross-checks vs the CPU oracle.

The projective path reformulates Möller–Trumbore as coefficients affine in
pixel coords (fwd_tiled._prep_projective_coefs): t = t_num/det * |d| instead
of the oracle's normalized-direction evaluation, so agreement is numerical
(f32), not bitwise — parity thresholds match the brute pinhole test's.
"""

import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, pinhole_camera
from opencl_ray_tracer.kernels.fwd_tiled import bin_scene, render_tiled
from opencl_ray_tracer.ref import render_reference
from opencl_ray_tracer.scene import random_scene

W, H = 256, 128  # 2x2 tiles of 128x64


def cam(w=W, h=H, pos=(320.0, 240.0, 300.0), look=(320.0, 240.0, -85.0)):
    return pinhole_camera(
        position=pos, look_at=look, fov_degrees=60.0, width=w, height=h
    )


def frac_identical(a, b):
    return np.all(np.asarray(a) == np.asarray(b), axis=-1).mean()


def frac_close(a, b, tol=0.5):
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return (diff.max(axis=-1) < tol).mean()


def test_pinhole_tiled_legacy_parity(scene1):
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    c = cam()
    oracle = render_reference(scene1, c, cfg)
    tiled = render_tiled(scene1, c, cfg, interpret=True)
    assert tiled.shape == (H, W, 4)
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"
    assert np.any(np.asarray(tiled)[..., :3] != 0)  # actually sees the scene


def test_pinhole_tiled_culling_vs_oracle(scene3_small):
    """Perspective bboxes must not cull any visible primitive."""
    cfg = RenderConfig(width=W, height=H, shading="legacy", cull_k=64)
    c = cam()
    oracle = render_reference(scene3_small, c, cfg)
    tiled = render_tiled(scene3_small, c, cfg, interpret=True)
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"


@pytest.mark.parametrize("shading,shadows", [("lambert", False), ("phong", True)])
def test_pinhole_tiled_shaded_parity(scene1, shading, shadows):
    cfg = RenderConfig(
        width=W, height=H, shading=shading, shadows=shadows,
        framebuffer_dtype="float",
    )
    c = cam()
    oracle = render_reference(scene1, c, cfg)
    tiled = render_tiled(scene1, c, cfg, interpret=True)
    close = frac_close(oracle, tiled)
    assert close > 0.995, f"only {close:.4%} of pixels within 0.5/255"


def test_pinhole_prim_behind_camera():
    """A primitive behind the camera gets a conservative full-screen bbox
    and must still never be hit (tca < 0 / negative det-side tests)."""
    scene = random_scene(6, 2, seed=11, bounds=(600.0, 440.0))
    # camera inside the scene volume looking at one corner: some prims end
    # up behind it
    c = pinhole_camera(
        position=(300.0, 220.0, -40.0), look_at=(0.0, 0.0, -85.0),
        fov_degrees=70.0, width=W, height=H,
    )
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    oracle = render_reference(scene, c, cfg)
    tiled = render_tiled(scene, c, cfg, interpret=True)
    frac = frac_identical(tiled, oracle)
    assert frac > 0.995, f"only {frac:.4%} identical"


def test_pinhole_bins_reuse_and_mismatch(scene1):
    """Precomputed projective bins render identically; ortho bins with a
    pinhole camera are rejected."""
    cfg = RenderConfig(width=W, height=H, shading="legacy")
    c = cam()
    packed = scene1.pack()
    bins = bin_scene(
        packed, height=H, width=W, k=cfg.cull_k, shadows=False, camera=c
    )
    assert bins.projective
    a = render_tiled(scene1, c, cfg, interpret=True)
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled_packed

    b = render_tiled_packed(packed, c, cfg, bins=bins, interpret=True)
    assert np.array_equal(np.asarray(a), np.asarray(b))

    ortho_bins = bin_scene(packed, height=H, width=W, k=cfg.cull_k)
    with pytest.raises(ValueError, match="mismatch"):
        render_tiled_packed(packed, c, cfg, bins=ortho_bins, interpret=True)
