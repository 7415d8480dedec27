"""Controller (gamepad) state machine + MSAA supersampling + dynamic blit.

Controller semantics mirror input/Controller.{h,cpp} (buttons through the
Pressed->Held->Released->None lifecycle, stick/trigger normalisation from
raw s16, deadzone front-end InputManager.cpp:456-466); MSAA honours
Settings.msaa end-to-end (defaultSettings.xml:6, Platform.cpp:274-310) as
sub-pixel supersampling through the affine camera bundle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera, render
from opencl_ray_tracer.app.controller import (
    AXIS_MAX,
    AXIS_MIN,
    Axis1D,
    Axis2D,
    Button,
    Controller,
)
from opencl_ray_tracer.app.input import InputManager
from opencl_ray_tracer.config import Settings
from opencl_ray_tracer.models.renderer import MSAA_OFFSETS


# -- Controller ---------------------------------------------------------------

def test_button_lifecycle():
    pad = Controller(0)
    pad.feed_button_down(Button.A)
    pad.update()  # applies the queued event
    assert pad.was_button_pressed(Button.A)
    assert pad.is_button_held(Button.A)
    assert not pad.was_button_released(Button.A)
    pad.update()  # Pressed -> Held
    assert not pad.was_button_pressed(Button.A)
    assert pad.is_button_held(Button.A)
    pad.feed_button_up(Button.A)
    pad.update()
    assert pad.was_button_released(Button.A)
    assert not pad.is_button_held(Button.A)
    pad.update()  # Released -> None
    assert not pad.was_button_released(Button.A)
    assert not pad.is_button_held(Button.A)


def test_same_frame_press_release_last_event_wins():
    # down then up in one frame leaves Released — the last event's state,
    # as in the reference's event loop (Controller.cpp:181-190)
    pad = Controller(0)
    pad.feed_button_down(Button.X)
    pad.feed_button_up(Button.X)
    pad.update()
    assert pad.was_button_released(Button.X)
    assert not pad.was_button_pressed(Button.X)


def test_axis_normalisation_matches_reference_formula():
    pad = Controller(0)
    pad.feed_axis_raw("leftx", AXIS_MAX)
    pad.feed_axis_raw("lefty", AXIS_MIN)
    x, y = pad.get_axis_2d(Axis2D.LEFT_STICK)
    assert x == pytest.approx(1.0)
    assert y == pytest.approx(-1.0)
    # raw 0 is NOT exactly 0 under the reference's shift-then-scale
    # (Utility.cpp:88-106): (32768/65535 - 0.5) * 2
    pad.feed_axis_raw("rightx", 0)
    rx, _ = pad.get_axis_2d(Axis2D.RIGHT_STICK)
    assert rx == pytest.approx((32768.0 / 65535.0 - 0.5) * 2.0)
    # triggers are 0..1 over 0..AXIS_MAX (Controller.cpp:171-177)
    pad.feed_axis_raw("lefttrigger", AXIS_MAX // 2)
    assert pad.get_axis_1d(Axis1D.LEFT_TRIGGER) == pytest.approx(0.5, abs=1e-4)
    assert pad.get_axis_1d(Axis1D.RIGHT_TRIGGER) == 0.0


def test_input_manager_gamepad_frontend():
    im = InputManager()
    assert im.get_num_controllers() == 0
    # invalid indices answer False/0, never raise (the reference's guards)
    assert not im.was_controller_button_pressed(0, Button.A)
    assert im.get_controller_axis_1d(3, Axis1D.LEFT_TRIGGER) == 0.0
    assert im.get_controller_axis_2d(3, Axis2D.LEFT_STICK) == (0.0, 0.0)

    pad = im.add_controller("test-pad")
    assert im.get_num_controllers() == 1
    pad.feed_button_down(Button.START)
    im.update()  # applies the queued pad event
    assert im.was_controller_button_pressed(0, Button.START)
    im.update()  # Pressed -> Held
    assert not im.was_controller_button_pressed(0, Button.START)
    assert im.is_controller_button_held(0, Button.START)


def test_deadzone():
    im = InputManager()
    pad = im.add_controller()
    # default deadzone 0.2 (InputManager.cpp:258)
    pad.feed_axis_raw("leftx", int(0.1 * AXIS_MAX))
    assert not im.is_controller_axis_in_use(0, Axis2D.LEFT_STICK)
    pad.feed_axis_raw("leftx", int(0.5 * AXIS_MAX))
    assert im.is_controller_axis_in_use(0, Axis2D.LEFT_STICK)
    im.set_dead_zone(0.6)
    assert not im.is_controller_axis_in_use(0, Axis2D.LEFT_STICK)


def test_rumble_headless():
    im = InputManager()
    pad = im.add_controller(rumble_supported=True)
    im.play_controller_rumble(0, 0.75, 500)
    assert pad.rumble_active == (0.75, 500)
    im.stop_controller_rumble(0)
    assert pad.rumble_active is None
    pad2 = im.add_controller(rumble_supported=False)
    im.play_controller_rumble(1, 1.0, 100)
    assert pad2.rumble_active is None  # unsupported: silent no-op


# -- MSAA ---------------------------------------------------------------------

def test_msaa4_equals_mean_of_subpixel_renders(scene1):
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=128, height=64, shading="legacy",
                       backend="xla", msaa=4)
    got = np.asarray(render(scene1, cam, cfg))
    cfg1 = cfg.replace(msaa=0, framebuffer_dtype="float")
    acc = sum(
        np.asarray(render(scene1, cam.shift_subpixel(dx, dy), cfg1))
        for dx, dy in MSAA_OFFSETS[4]
    )
    want = np.round(acc / 4.0).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_msaa_smooths_edges(scene1):
    cam = legacy_ortho_camera()
    base = RenderConfig(width=128, height=64, shading="legacy", backend="xla")
    hard = np.asarray(render(scene1, cam, base)).astype(np.float32)
    aa = np.asarray(render(scene1, cam, base.replace(msaa=4))).astype(
        np.float32
    )
    # Interior pixels move by at most the depth-fog gradient of a sub-pixel
    # shift (legacy shading attenuates by hit distance, so nearly every hit
    # pixel wiggles a little); silhouette pixels become genuine blends.
    assert not np.array_equal(hard, aa)
    diff = np.abs(hard - aa).max(axis=-1)
    assert np.mean(diff) < 5.0, "MSAA changed the image wholesale"
    assert np.max(diff) > 20.0, "no edge pixel was actually blended"
    # the background (miss everywhere) stays exactly black
    miss = np.all(hard[..., :3] == 0, axis=-1) & (diff == 0)
    assert miss.any()


def test_msaa_from_settings_end_to_end():
    s = Settings.from_xml(
        "<Settings><Width>640</Width><Height>480</Height>"
        "<MSAA>4</MSAA></Settings>"
    )
    cfg = RenderConfig.from_settings(s, shading="legacy")
    assert cfg.msaa == 4
    with pytest.raises(Exception):
        RenderConfig(width=640, height=480, msaa=3).validate()


@pytest.mark.parametrize("n", [2, 8, 16])
def test_msaa_offsets_well_formed(n):
    offs = MSAA_OFFSETS[n]
    assert len(offs) == n
    assert len(set(offs)) == n
    for dx, dy in offs:
        assert -0.5 <= dx <= 0.5 and -0.5 <= dy <= 0.5
    # patterns are centered (zero mean -> no image shift)
    np.testing.assert_allclose(np.mean(offs, axis=0), 0.0, atol=1e-6)


# -- dynamic (traced-position) blit -------------------------------------------

def test_blit_traced_positions_match_host_ints():
    from opencl_ray_tracer.utils.texture import blit

    rng = np.random.default_rng(0)
    dest = jnp.asarray(rng.uniform(0, 255, (32, 48, 4)).astype(np.float32))
    src = jnp.asarray(rng.uniform(0, 255, (8, 10, 4)).astype(np.float32))

    jit_blit = jax.jit(lambda d, s, x, y: blit(d, s, (x, y)))
    for pos in [(5, 7), (-3, -2), (44, 28), (100, 100)]:
        want = np.asarray(blit(dest, src, pos))
        got = np.asarray(
            jit_blit(dest, src, jnp.int32(pos[0]), jnp.int32(pos[1]))
        )
        np.testing.assert_allclose(got, want, atol=1e-4), pos
