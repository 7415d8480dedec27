"""Config system, RNG, timers, logging, image IO, native library."""

import os
import time

import numpy as np
import pytest

from opencl_ray_tracer.config import (
    RenderConfig,
    Settings,
    SettingsError,
    load_config,
)
from opencl_ray_tracer.utils import (
    DeltaTime,
    PerformanceCounter,
    pack_rgba,
    read_png,
    rng,
    time_fn,
    write_png,
)


class TestSettings:
    def test_xml_roundtrip(self, tmp_path):
        p = tmp_path / "settings.xml"
        p.write_text(
            "<Settings><Width>800</Width><Height>600</Height>"
            "<Fullscreen>1</Fullscreen><MSAA>4</MSAA></Settings>"
        )
        s = Settings.from_xml(str(p))
        assert (s.width, s.height, s.fullscreen, s.msaa) == (800, 600, 1, 4)

    def test_first_run_copy(self, tmp_path):
        p = tmp_path / "prefs" / "settings.xml"
        s = Settings.init_settings_file(str(p))
        assert p.exists()
        assert s.width == 640 and s.height == 480

    def test_validation_bounds(self):
        """Resolution >= 640x480, like Platform.cpp:253-272."""
        with pytest.raises(SettingsError):
            Settings(width=320, height=240).validate()
        with pytest.raises(SettingsError):
            Settings(fullscreen=5).validate()
        with pytest.raises(SettingsError):
            Settings(msaa=3).validate()

    def test_bad_xml_value(self, tmp_path):
        p = tmp_path / "bad.xml"
        p.write_text("<Settings><Width>abc</Width></Settings>")
        with pytest.raises(SettingsError):
            Settings.from_xml(str(p))


class TestRenderConfig:
    def test_json_roundtrip(self, tmp_path):
        cfg = RenderConfig(width=1920, height=1080, shading="phong", shadows=True,
                           framebuffer_dtype="float", mesh_shape=(8,))
        p = tmp_path / "cfg.json"
        p.write_text(cfg.to_json())
        cfg2 = load_config(str(p))
        assert cfg2 == cfg

    def test_xml_to_config(self, tmp_path):
        p = tmp_path / "settings.xml"
        p.write_text("<Settings><Width>1024</Width><Height>768</Height></Settings>")
        cfg = load_config(str(p), shading="lambert", framebuffer_dtype="float")
        assert cfg.width == 1024 and cfg.shading == "lambert"

    def test_invalid_combos(self):
        with pytest.raises(ValueError):
            RenderConfig(shading="gouraud").validate()
        with pytest.raises(ValueError):
            RenderConfig(soft=True).validate()  # int fb + soft
        with pytest.raises(ValueError):
            RenderConfig(cull_k=100).validate()  # not a multiple of 8


class TestRng:
    def test_deterministic(self):
        a = rng.Random(42)
        b = rng.Random(42)
        assert [a.get_float(0, 1) for _ in range(5)] == [
            b.get_float(0, 1) for _ in range(5)
        ]

    def test_ranges(self):
        r = rng.Random(0)
        vals = [r.get_int(3, 7) for _ in range(100)]
        assert min(vals) >= 3 and max(vals) <= 7
        fvals = [r.get_float(-1.5, 2.5) for _ in range(100)]
        assert min(fvals) >= -1.5 and max(fvals) <= 2.5

    def test_uninitialized_warns_but_works(self):
        r = rng.Random()
        v = r.get_float(0, 1)
        assert 0 <= v <= 1


class TestTimers:
    def test_performance_counter_microseconds(self):
        pc = PerformanceCounter()
        pc.start_counter()
        time.sleep(0.01)
        us = pc.stop_counter()
        assert 8_000 < us < 500_000

    def test_delta_time(self):
        dt = DeltaTime()
        time.sleep(0.005)
        d = dt.update()
        assert 0.003 < d < 1.0

    def test_time_fn_stats(self):
        stats = time_fn(lambda: sum(range(1000)), iters=5, warmup=1)
        assert stats["min_us"] <= stats["median_us"] <= stats["max_us"]


class TestImageIO:
    def test_pack_clamps_like_display_path(self):
        fb = np.array([[[-20, 0, 255, 300]]], np.int32)
        out = pack_rgba(fb)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out[0, 0], [0, 0, 255, 255])

    def test_png_roundtrip(self, tmp_path):
        fb = np.random.randint(0, 256, (20, 30, 4), np.int32)
        p = str(tmp_path / "x.png")
        write_png(p, fb)
        back = read_png(p)
        np.testing.assert_array_equal(back, fb.astype(np.uint8))


class TestNative:
    def test_native_lib_available_and_consistent(self):
        from opencl_ray_tracer.native import (
            decode_png_native,
            encode_png_native,
            now_ns,
            pack_rgba_native,
        )

        assert now_ns() > 0
        fb = np.random.randint(-10, 280, (16, 24, 4), np.int32)
        packed = pack_rgba_native(fb)
        np.testing.assert_array_equal(
            packed, np.clip(fb, 0, 255).astype(np.uint8)
        )
        path = "/tmp/_octrt_native_test.png"
        encode_png_native(path, packed)
        back = decode_png_native(path)
        np.testing.assert_array_equal(back, packed)
        os.remove(path)
