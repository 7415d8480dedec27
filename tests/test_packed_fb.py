"""Packed-framebuffer output format (framebuffer_dtype='packed').

The tiled Pallas kernel can emit ONE int32 RGBA word per pixel (the
little-endian byte stream the PNG/display path consumes) instead of float
channel planes — the fix for the flagship kernel's memory-bound output
path. These tests pin the packed words to the unpacked render across camera
families, shadings, the empty-tile fast path, the brute overflow fallback,
and the facade's non-Pallas packing twin.
"""

import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera, render
from opencl_ray_tracer.kernels.fwd_tiled import render_tiled
from opencl_ray_tracer.scene import Scene, create_scene
from opencl_ray_tracer.utils.image import pack_rgba, unpack_words


@pytest.fixture(scope="module")
def scene1():
    return create_scene(1)


def _unpacked_bytes(scene, cam, cfg):
    """Reference bytes: unpacked render -> display-path clamping."""
    fb = render_tiled(scene, cam, cfg, interpret=True)
    return pack_rgba(np.asarray(fb))


@pytest.mark.parametrize(
    "shading,shadows,fbdt",
    [("legacy", False, "int"), ("phong", True, "float"),
     ("lambert", True, "float")],
)
def test_packed_matches_unpacked_ortho(scene1, shading, shadows, fbdt):
    cam = legacy_ortho_camera()
    cfg = RenderConfig(
        width=256, height=128, shading=shading, shadows=shadows,
        framebuffer_dtype=fbdt,
    )
    want = _unpacked_bytes(scene1, cam, cfg)
    got = render_tiled(scene1, cam, cfg.replace(framebuffer_dtype="packed"), interpret=True)
    assert got.shape == (128, 256)
    assert str(got.dtype) == "int32"
    np.testing.assert_array_equal(unpack_words(np.asarray(got)), want)


def test_packed_matches_unpacked_pinhole(scene1):
    from opencl_ray_tracer import pinhole_camera

    cam = pinhole_camera(
        position=(320.0, 240.0, 600.0), look_at=(320.0, 240.0, -85.0),
        fov_degrees=60.0, width=256, height=128,
    )
    cfg = RenderConfig(
        width=256, height=128, shading="phong", shadows=True,
        framebuffer_dtype="float",
    )
    want = _unpacked_bytes(scene1, cam, cfg)
    got = render_tiled(scene1, cam, cfg.replace(framebuffer_dtype="packed"), interpret=True)
    np.testing.assert_array_equal(unpack_words(np.asarray(got)), want)


def test_packed_empty_tiles_are_opaque_black():
    # One tiny sphere in the top-left corner: all other 64x128 tiles take
    # the empty-tile constant-store fast path and must be (0,0,0,255).
    scene = Scene.build(
        sphere_origin=[(10.0, 10.0, -50.0)],
        sphere_radius=[5.0],
        sphere_colour=[(1.0, 0.0, 0.0, 255.0)],
    )
    cfg = RenderConfig(
        width=512, height=256, shading="phong", shadows=True,
        framebuffer_dtype="packed",
    )
    fb = np.asarray(render_tiled(scene, legacy_ortho_camera(), cfg, interpret=True))
    rgba = unpack_words(fb)
    far = rgba[128:, 256:]  # tiles with no candidates
    assert (far[..., :3] == 0).all()
    assert (far[..., 3] == 255).all()
    # and the sphere actually rendered red somewhere
    assert rgba[..., 0].max() > 0


def test_packed_brute_overflow_fallback(scene1):
    # Under jit the overflow flag is traced, so lax.cond picks the XLA
    # fallback branch — which must emit exactly the packed words of the XLA
    # renderer it runs.
    import jax

    from opencl_ray_tracer.models.xla_backend import render_xla
    from opencl_ray_tracer.ops.shading import pack_framebuffer_words

    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=256, height=128, shading="legacy",
                       framebuffer_dtype="packed", cull_k=8)
    packed_scene = scene1.pack()
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled_packed

    fb = jax.jit(
        lambda p: render_tiled_packed(p, cam, cfg, interpret=True)
    )(packed_scene)
    want = pack_framebuffer_words(
        render_xla(scene1, cam, cfg.replace(framebuffer_dtype="float"))
    )
    np.testing.assert_array_equal(np.asarray(fb), np.asarray(want))


def test_facade_packed_nonpallas_backends(scene1):
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=256, height=128, shading="legacy",
                       framebuffer_dtype="packed")
    a = np.asarray(render(scene1, cam, cfg.replace(interpret=True),
                          backend="pallas"))
    b = np.asarray(render(scene1, cam, cfg, backend="xla"))
    c = np.asarray(render(scene1, cam, cfg, backend="reference"))
    assert a.shape == b.shape == c.shape == (128, 256)
    # Backends differ by ulps at object edges (the established cross-backend
    # tolerance is fraction-of-identical-pixels > 0.995, test_pallas_tiled).
    for x, y in ((a, b), (b, c)):
        frac = (x == y).mean()
        assert frac > 0.995, f"only {frac:.4%} identical"


def test_facade_packed_msaa(scene1):
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=256, height=128, shading="phong", shadows=True,
                       framebuffer_dtype="packed", msaa=4)
    fb = np.asarray(render(scene1, cam, cfg))
    assert fb.shape == (128, 256)
    rgba = unpack_words(fb)
    assert (rgba[..., 3] == 255).all()


def test_write_png_accepts_packed(tmp_path, scene1):
    from opencl_ray_tracer.utils.image import read_png, write_png

    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=256, height=128, shading="phong", shadows=True,
                       framebuffer_dtype="packed")
    fb = np.asarray(render_tiled(scene1, cam, cfg, interpret=True))
    p = tmp_path / "packed.png"
    write_png(str(p), fb)
    round_trip = read_png(str(p))
    np.testing.assert_array_equal(round_trip, unpack_words(fb))


def test_cull_k_divisibility_rejected():
    with pytest.raises(ValueError, match="cull_k"):
        RenderConfig(cull_k=20).validate()
    with pytest.raises(ValueError, match="shadow_cull_k"):
        RenderConfig(shadow_cull_k=12).validate()


def test_packed_all_empty_frame():
    """Every tile empty (primitives
    entirely outside the frame) -> pure background, correct alpha."""
    scene = Scene.build(
        sphere_origin=[(-500.0, -500.0, -50.0)],
        sphere_radius=[5.0],
        sphere_colour=[(1.0, 0.0, 0.0, 255.0)],
    )
    cfg = RenderConfig(width=256, height=128, shading="phong", shadows=True,
                       framebuffer_dtype="packed")
    fb = np.asarray(render_tiled(scene, legacy_ortho_camera(), cfg, interpret=True))
    rgba = unpack_words(fb)
    assert (rgba[..., :3] == 0).all()
    assert (rgba[..., 3] == 255).all()


def test_cli_render_packed(tmp_path):
    from opencl_ray_tracer.cli import main

    out = str(tmp_path / "p.png")
    rc = main(["render", "--scene", "1", "--packed", "--width", "640",
               "--height", "480", "--out", out])
    assert rc == 0
    from opencl_ray_tracer.utils.image import read_png

    img = read_png(out)
    assert img.shape == (480, 640, 4)
    assert (img[..., 3] == 255).all()
