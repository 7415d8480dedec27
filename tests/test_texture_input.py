"""Texture compositing (SURVEY §2 #10) + mouse input (#16) coverage."""

import numpy as np

from opencl_ray_tracer.app.input import ButtonState, InputManager
from opencl_ray_tracer.utils.texture import (
    Texture,
    blit,
    resize_nearest,
)


def solid(h, w, rgba):
    img = np.zeros((h, w, 4), np.float32)
    img[:] = rgba
    return img


def test_blit_opaque_and_clip():
    dest = solid(8, 8, (10.0, 20.0, 30.0, 255.0))
    src = solid(4, 4, (200.0, 0.0, 0.0, 255.0))
    out = np.asarray(blit(dest, src, (2, 3)))
    assert np.allclose(out[3:7, 2:6, 0], 200.0)
    assert np.allclose(out[0, 0], [10.0, 20.0, 30.0, 255.0])
    # off-edge clip: top-left corner partially outside
    out2 = np.asarray(blit(dest, src, (-2, -2)))
    assert np.allclose(out2[0:2, 0:2, 0], 200.0)
    assert np.allclose(out2[4:, 4:, 0], 10.0)
    # fully outside: unchanged
    out3 = np.asarray(blit(dest, src, (100, 100)))
    np.testing.assert_array_equal(out3, dest)


def test_blit_alpha_blend():
    dest = solid(4, 4, (0.0, 0.0, 0.0, 255.0))
    src = solid(4, 4, (255.0, 0.0, 0.0, 127.5))  # 50% alpha
    out = np.asarray(blit(dest, src, (0, 0)))
    assert abs(out[2, 2, 0] - 127.5) < 1e-3
    assert out[2, 2, 3] == 255.0  # dest alpha preserved


def test_texture_draw_scaled_and_tint():
    dest = solid(8, 8, (0.0, 0.0, 0.0, 255.0))
    tex = Texture(solid(2, 2, (100.0, 100.0, 100.0, 255.0)))
    tex = tex.set_colour_tint(1.0, 0.5, 0.0)
    out = np.asarray(tex.draw_scaled(dest, (0, 0), (8, 8)))
    assert np.allclose(out[..., 0], 100.0)
    assert np.allclose(out[..., 1], 50.0)
    assert np.allclose(out[..., 2], 0.0)
    assert tex.dimensions == (2, 2)


def test_resize_nearest_shapes():
    img = np.arange(2 * 2 * 4, dtype=np.float32).reshape(2, 2, 4)
    up = np.asarray(resize_nearest(img, 4, 6))
    assert up.shape == (4, 6, 4)
    assert np.allclose(up[0, 0], img[0, 0])
    assert np.allclose(up[-1, -1], img[-1, -1])


def test_texture_rotated_draw_90deg():
    """90-degree rotation about the centre permutes pixels exactly; outside
    samples are transparent and leave the destination untouched."""
    src = np.zeros((4, 4, 4), np.float32)
    src[..., 3] = 255.0
    src[0, :, 0] = 255.0  # top row red
    tex = Texture(src)
    dest = solid(4, 4, (0.0, 0.0, 7.0, 255.0))
    # pivot at the pixel-grid centre (1.5, 1.5) makes the 90-degree map an
    # exact permutation of the 4x4 grid
    out = np.asarray(
        tex.draw(dest, (0, 0), rotation_degrees=90.0, pivot=(1.5, 1.5))
    )
    # top row maps onto a column after rotation
    reds = out[..., 0] > 128
    assert reds.sum() == 4
    assert len({tuple(np.nonzero(reds)[1])}) == 1  # all in one column


def test_mouse_lifecycle():
    im = InputManager()
    im.feed_mouse_move(10, 20)
    im.feed_mouse_down("left")
    im.update()
    assert im.mouse_pos() == (10, 20)
    assert im.mouse_delta() == (10, 20)
    assert im.was_mouse_pressed("left")
    assert im.is_mouse_held("left")
    im.update()
    assert not im.was_mouse_pressed("left")   # Pressed -> Held
    assert im.is_mouse_held("left")
    assert im.mouse_delta() == (0, 0)
    im.feed_mouse_up("left")
    im.feed_mouse_wheel(3)
    im.update()
    assert im.was_mouse_released("left")
    assert im.mouse_wheel() == 3
    im.update()
    assert im.key_state("mouse:left") == ButtonState.NONE
    assert im.mouse_wheel() == 0
