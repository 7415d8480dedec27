"""Math utilities, memory counter, platform info, profiling, checkpointing."""

import numpy as np
import optax
import pytest

from opencl_ray_tracer.utils import mathutil, memory, platform_info, profiling


class TestMathUtil:
    def test_normalise_float_is_the_shading_curve(self):
        # 255 - normalise(t, 180, 0)*255 at t=90 -> 127.5 (rayTracer.cl:193)
        assert mathutil.normalise_float(90.0, 180.0) == 0.5
        # no clamping: overshoot beyond max (legacy negative-colour quirk)
        assert mathutil.normalise_float(360.0, 180.0) == 2.0

    def test_deg_rad_roundtrip(self):
        assert np.isclose(mathutil.deg_to_rad(180.0), np.pi)
        assert np.isclose(mathutil.rad_to_deg(np.pi / 2), 90.0)

    def test_rect_helpers(self):
        r = mathutil.Rect(10, 20, 30, 40)
        assert r.center == (25.0, 40.0)
        assert mathutil.rects_intersect(r, mathutil.Rect(35, 55, 10, 10))
        assert not mathutil.rects_intersect(r, mathutil.Rect(100, 100, 5, 5))

    def test_line_intersect(self):
        p = mathutil.line_intersect((0, 0), (10, 10), (0, 10), (10, 0))
        assert p is not None and np.allclose(p, (5, 5))
        assert mathutil.line_intersect((0, 0), (1, 1), (5, 5), (6, 6)) is None

    def test_line_rect_intersect(self):
        r = mathutil.Rect(4, 4, 2, 2)
        assert mathutil.line_rect_intersect((0, 5), (10, 5), r)
        assert not mathutil.line_rect_intersect((0, 0), (10, 0), r)


class TestMemory:
    def test_host_memory_positive(self):
        assert memory.get_host_memory_usage_bytes() > 10_000_000

    def test_report_renders(self):
        rep = memory.format_memory_report()
        assert "host rss" in rep


class TestPlatformInfo:
    def test_system_info_fields(self):
        info = platform_info.system_info()
        for key in ("os", "jax", "backend", "devices", "cpu_count"):
            assert key in info
        assert len(info["devices"]) >= 1


class TestProfiling:
    def test_sol_fraction_model(self):
        out = profiling.sol_fraction(
            frame_us=1000.0, n_pixels=2_073_600, n_prim_slots=32,
            peaks=profiling.device_peaks("NVIDIA H100 80GB HBM3"),
        )
        assert out["bound"] in ("alu", "dram")
        assert 0 < out["achieved_fraction"] < 10

    def test_annotate_runs(self):
        with profiling.annotate("test-region"):
            pass


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        import jax.numpy as jnp

        from opencl_ray_tracer.parallel import init_train_state
        from opencl_ray_tracer.parallel.checkpoint import (
            latest_checkpoint,
            load_checkpoint,
            resume_or_init,
            save_checkpoint,
        )
        from opencl_ray_tracer.scene import Scene

        scene = Scene.build(
            sphere_origin=[[1.0, 2.0, -3.0]],
            sphere_radius=[4.0],
            sphere_colour=[[1.0, 0.0, 0.0, 255.0]],
        )
        opt = optax.adam(1e-2)
        state = init_train_state(scene, opt)
        state = state._replace(step=jnp.int32(7))

        path = str(tmp_path / "ckpts")
        save_checkpoint(path, state)
        assert latest_checkpoint(path) is not None

        state0 = init_train_state(scene, opt)
        restored = resume_or_init(path, state0)
        assert int(restored.step) == 7
        np.testing.assert_allclose(
            np.asarray(restored.scene.sphere_radius), [4.0]
        )

    def test_resume_without_checkpoint_returns_init(self, tmp_path):
        import jax.numpy as jnp

        from opencl_ray_tracer.parallel import init_train_state
        from opencl_ray_tracer.parallel.checkpoint import resume_or_init
        from opencl_ray_tracer.scene import Scene

        scene = Scene.build(
            sphere_origin=[[0.0, 0.0, -1.0]],
            sphere_radius=[1.0],
            sphere_colour=[[1.0, 1.0, 1.0, 255.0]],
        )
        state = init_train_state(scene, optax.sgd(0.1))
        out = resume_or_init(str(tmp_path / "none"), state)
        assert out is state


class TestDisplay:
    def test_render_ansi_shape_and_codes(self):
        from opencl_ray_tracer.utils import render_ansi

        fb = np.zeros((64, 128, 4), np.int32)
        fb[:, :, 0] = 200  # red field
        s = render_ansi(fb, max_width=32, max_height=16)
        lines = s.split("\n")
        # 128x64 at max_width 32 scales 0.25x -> 16 image rows -> 8 text
        # lines (two image rows per half-block line)
        assert len(lines) == 8
        assert "\x1b[38;2;200;0;0m" in s and "\x1b[48;2;200;0;0m" in s
        assert lines[0].endswith("\x1b[0m")

    def test_render_ansi_halfblock_pairs_rows(self):
        from opencl_ray_tracer.utils import render_ansi

        fb = np.zeros((4, 4, 4), np.float32)
        fb[0::2, :, 1] = 255.0  # green stripes on even rows
        s = render_ansi(fb, max_width=4, max_height=2)
        # top pixel (fg) green, bottom (bg) black in every cell
        assert "\x1b[38;2;0;255;0m\x1b[48;2;0;0;0m" in s

    def test_app_display_key(self, capsys):
        from opencl_ray_tracer import RenderConfig
        from opencl_ray_tracer.app import (
            InputManager, MainState, StateManager,
        )

        cfg = RenderConfig(width=128, height=64, shading="legacy",
                           backend="xla")
        sm = StateManager()
        st = MainState(sm, InputManager(), config=cfg)
        sm.add_state(st)
        sm.update(0.016)
        sm.event_handler("d")
        sm.update(0.016)
        out = capsys.readouterr().out
        assert "\x1b[38;2;" in out, "no ANSI framebuffer was printed"
