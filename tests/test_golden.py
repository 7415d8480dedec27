"""Golden-image regression tests.

The reference sketched this and never wired it up (encodePNG call commented
out, MainState.cpp:971; SURVEY.md §4.3). Here it is real: tiny golden PNGs
committed under tests/golden/, regenerated with
`python tests/test_golden.py regen`.

Two engine families are pinned: the CPU oracle (render_reference) AND the
accelerated Pallas tiled paths (ortho + pinhole, legacy + phong, plus the
soft differentiable renderer) — so a Pallas numeric drift that parity
tests' tolerances would absorb trips a byte-level wire here (>0.1% of
pixels changed fails)."""

import os
import sys

import numpy as np
import pytest

from opencl_ray_tracer import (
    RenderConfig,
    create_scene,
    legacy_ortho_camera,
    pinhole_camera,
)
from opencl_ray_tracer.utils import pack_rgba, read_png, write_png

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
W, H = 160, 120

# name -> (engine, scene, shading, shadows, camera)
CASES = [
    ("scene1_legacy", "oracle", 1, "legacy", False, "ortho"),
    ("scene2_legacy", "oracle", 2, "legacy", False, "ortho"),
    ("scene1_phong", "oracle", 1, "phong", True, "ortho"),
    ("pallas_scene1_legacy", "pallas", 1, "legacy", False, "ortho"),
    ("pallas_scene1_phong", "pallas", 1, "phong", True, "ortho"),
    ("pallas_scene1_pinhole", "pallas", 1, "legacy", False, "pinhole"),
    ("pallas_scene1_pinhole_phong", "pallas", 1, "phong", True, "pinhole"),
    ("pallas_soft_scene1_phong", "soft", 1, "phong", True, "ortho"),
]


def _camera(kind):
    if kind == "pinhole":
        # close camera: hit distances stay under the legacy fog horizon
        # (t=180, rayTracer.cl:193), so the legacy-pinhole golden carries
        # actual content instead of a trivially-black frame
        return pinhole_camera(
            position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
            fov_degrees=80.0, width=W, height=H,
        )
    return legacy_ortho_camera()


def render_case(engine, scene_num, shading, shadows, cam_kind):
    cam = _camera(cam_kind)
    scene = create_scene(scene_num, seed=0)
    if engine == "soft":
        from opencl_ray_tracer.kernels.soft_tiled import render_soft_tiled

        cfg = RenderConfig(
            width=W, height=H, shading=shading, shadows=shadows, soft=True,
            framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
        )
        fb = render_soft_tiled(scene, cam, cfg, interpret=True)
    elif engine == "pallas":
        from opencl_ray_tracer.kernels.fwd_tiled import render_tiled

        cfg = RenderConfig(
            width=W, height=H, shading=shading, shadows=shadows,
            framebuffer_dtype="int" if shading == "legacy" else "float",
        )
        fb = render_tiled(scene, cam, cfg, interpret=True)
    else:
        from opencl_ray_tracer.ref import render_reference

        cfg = RenderConfig(
            width=W, height=H, shading=shading, shadows=shadows,
            framebuffer_dtype="int" if shading == "legacy" else "float",
        )
        fb = render_reference(scene, cam, cfg)
    return pack_rgba(fb)


@pytest.mark.parametrize("name,engine,scene_num,shading,shadows,cam", CASES)
def test_golden(name, engine, scene_num, shading, shadows, cam):
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    assert os.path.exists(path), (
        f"golden {path} missing — run `python tests/test_golden.py regen`"
    )
    want = read_png(path)
    got = render_case(engine, scene_num, shading, shadows, cam)
    same = np.all(got == want, axis=-1).mean()
    # byte-exact except for a tolerance on future fp changes at edges
    assert same > 0.999, f"{name}: only {same:.4%} identical to golden"


def regen():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, engine, scene_num, shading, shadows, cam in CASES:
        img = render_case(engine, scene_num, shading, shadows, cam)
        write_png(os.path.join(GOLDEN_DIR, f"{name}.png"), img.astype(np.int32))
        print("wrote", name)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        import jax

        jax.config.update("jax_platforms", "cpu")
        regen()
