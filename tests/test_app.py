"""App shell tests: state machine semantics, input edge detection, and the
scripted benchmark harness (F1/F2/SPACE controls)."""

import numpy as np

from opencl_ray_tracer import RenderConfig
from opencl_ray_tracer.app import (
    ButtonState,
    InputManager,
    MainState,
    State,
    StateManager,
    run_scripted,
)


class TestInputManager:
    def test_press_hold_release_cycle(self):
        im = InputManager()
        im.feed_key_down("a")
        im.update()
        assert im.was_key_pressed("a") and im.is_key_held("a")
        im.update()
        assert not im.was_key_pressed("a") and im.is_key_held("a")
        im.feed_key_up("a")
        im.update()
        assert im.was_key_released("a") and not im.is_key_held("a")
        im.update()
        assert im.key_state("a") == ButtonState.NONE

    def test_tap(self):
        im = InputManager()
        im.feed_key_tap("F1")
        im.update()
        assert im.was_key_pressed("F1")
        im.update()
        assert im.was_key_released("F1")
        im.update()
        assert im.key_state("F1") == ButtonState.NONE


class TestStateManager:
    def test_stack_semantics(self):
        sm = StateManager()

        class Named(State):
            def __init__(self, mgr, name):
                super().__init__(mgr)
                self.name = name
                self.updates = 0

            def update(self, dt):
                self.updates += 1

            def render(self):
                return self.name

        a, b = Named(sm, "a"), Named(sm, "b")
        sm.add_state(a)
        sm.add_state(b)
        sm.update(0.016)
        # update goes only to the top state; render to all bottom-up
        assert (a.updates, b.updates) == (0, 1)
        assert sm.render() == ["a", "b"]
        sm.pop_last_state()
        assert sm.top is a


class TestMainStateHarness:
    def make(self, **kw):
        cfg = RenderConfig(width=128, height=64, shading="legacy", backend="xla")
        sm = StateManager()
        st = MainState(sm, InputManager(), config=cfg, **kw)
        sm.add_state(st)
        return sm, st

    def test_startup_runs_trace(self):
        sm, st = self.make()
        sm.update(0.016)
        assert st.framebuffer is not None
        assert st.framebuffer.shape == (64, 128, 4)
        assert st.time_taken_us is not None and st.time_taken_us > 0

    def test_scene_cycle_and_rerun(self):
        sm, st = self.make()
        lines = run_scripted(sm, ["r", "s", "s"])
        assert st.current_scene == 3
        assert any("Scene 3" in l for l in lines)

    def test_backend_cycle(self):
        sm, st = self.make()
        sm.update(0.016)
        start = st.backend
        sm.event_handler("m")
        sm.update(0.016)
        sm.update(0.016)
        assert st.backend != start

    def test_gamepad_drives_harness(self):
        """Pad buttons mirror the keyboard bindings: X = mode, Y = scene,
        A = re-run (component #16 wired into the state machine)."""
        from opencl_ray_tracer.app.controller import Button

        sm, st = self.make()
        sm.update(0.016)
        pad = st.inputs.add_controller("test-pad")
        start_backend, start_scene = st.backend, st.current_scene
        pad.feed_button_down(Button.X)
        sm.update(0.016)
        assert st.backend != start_backend
        pad.feed_button_down(Button.Y)
        sm.update(0.016)
        assert st.current_scene == start_scene % 3 + 1
        fb_before = st.framebuffer
        pad.feed_button_down(Button.A)
        sm.update(0.016)
        assert st.framebuffer is not None and st.framebuffer is not fb_before

    def test_quit(self):
        sm, st = self.make()
        assert sm.event_handler("q") is False

    def test_png_dump(self, tmp_path):
        sm, st = self.make(png_dir=str(tmp_path))
        run_scripted(sm, ["r", "p"])
        files = list(tmp_path.glob("*.png"))
        assert len(files) == 1
        from opencl_ray_tracer.utils import read_png

        img = read_png(str(files[0]))
        assert img.shape == (64, 128, 4)
        fb = np.clip(np.asarray(st.framebuffer), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(img, fb)


def test_display_mode_blits_every_new_frame(capsys):
    """--display re-blits the ANSI framebuffer whenever a trace produced a
    new image (the per-frame window blit of MainState.cpp:241-254,
    coalesced to framebuffer changes)."""
    cfg = RenderConfig(width=128, height=64, shading="legacy", backend="xla")
    sm = StateManager()
    st = MainState(sm, InputManager(), config=cfg, display=True)
    sm.add_state(st)
    sm.update(0.016)  # startup trace -> blit
    out1 = capsys.readouterr().out
    assert "\x1b[" in out1
    sm.update(0.016)  # no new trace -> no re-blit
    assert "\x1b[" not in capsys.readouterr().out
    sm.event_handler("r")
    sm.update(0.016)  # re-run -> new framebuffer -> blit again
    assert "\x1b[" in capsys.readouterr().out
