"""Checkpoint/resume in its production seat (fit_scene / cli fit) and the
generalized cmd_fit surface.

Interrupted-run semantics: fit 10 steps in one run vs fit 5 steps
(checkpointed), "crash", then call fit_scene again for the remaining 5 —
the resumed run must land on the same state as the uninterrupted one.
"""

import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
from opencl_ray_tracer.diff import render_soft
from opencl_ray_tracer.models.inverse import (
    SPHERE_PARAMS,
    fit_scene,
    perturb_scene,
)
from opencl_ray_tracer.scene import Scene

W, H = 128, 64


@pytest.fixture(scope="module")
def problem():
    cfg = RenderConfig(width=W, height=H, shading="lambert", soft=True,
                       framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.75,
                       mesh_shape=(2,))
    cam = legacy_ortho_camera()
    true_scene = Scene.build(
        sphere_origin=[[W * 0.5, H * 0.5, -60.0]],
        sphere_radius=[H * 0.3],
        sphere_colour=[[1.0, 0.3, 0.2, 255.0]],
    )
    target = render_soft(true_scene, cam, cfg)
    init = Scene.build(
        sphere_origin=[[W * 0.6, H * 0.4, -60.0]],
        sphere_radius=[H * 0.22],
        sphere_colour=[[0.6, 0.5, 0.5, 255.0]],
    )
    return cfg, cam, target, init


def test_fit_resumes_from_checkpoint(problem, tmp_path):
    cfg, cam, target, init = problem
    kw = dict(camera=cam, config=cfg, learning_rate=0.3,
              trainable=SPHERE_PARAMS, log_every=100)

    straight, _ = fit_scene(init, target, steps=10, **kw)

    ckdir = str(tmp_path / "ck")
    # first run "killed" after 5 steps (checkpoint_every=5 saves at step 5)
    fit_scene(init, target, steps=5, checkpoint_dir=ckdir,
              checkpoint_every=5, **kw)
    # resumed run: starts from the step-5 checkpoint, runs steps 5..9
    resumed, losses = fit_scene(init, target, steps=10, checkpoint_dir=ckdir,
                                checkpoint_every=5, **kw)
    np.testing.assert_allclose(
        np.asarray(resumed.sphere_origin),
        np.asarray(straight.sphere_origin),
        rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(resumed.sphere_radius),
        np.asarray(straight.sphere_radius),
        rtol=0, atol=1e-5,
    )


def test_fit_resume_past_end_is_noop(problem, tmp_path):
    cfg, cam, target, init = problem
    ckdir = str(tmp_path / "ck2")
    kw = dict(camera=cam, config=cfg, learning_rate=0.3,
              trainable=SPHERE_PARAMS, log_every=100,
              checkpoint_dir=ckdir, checkpoint_every=3)
    a, _ = fit_scene(init, target, steps=3, **kw)
    b, losses = fit_scene(init, target, steps=3, **kw)  # already done
    assert losses == []
    np.testing.assert_array_equal(
        np.asarray(a.sphere_origin), np.asarray(b.sphere_origin)
    )


def test_perturb_scene_jitters_only_spheres():
    from opencl_ray_tracer.scene import create_scene

    s = create_scene(1)
    p = perturb_scene(s, seed=3)
    assert not np.allclose(np.asarray(p.sphere_origin),
                           np.asarray(s.sphere_origin))
    np.testing.assert_array_equal(np.asarray(p.tri_verts),
                                  np.asarray(s.tri_verts))
    assert np.asarray(p.sphere_colour)[:, :3].min() >= 0.05


def test_cmd_fit_general_surface(tmp_path, capsys):
    """cli fit runs the pinhole+phong path on a library scene at the scene's
    native 640x480 frame. backend=xla keeps the CPU smoke fast
    (the jnp twin instead of interpret-mode Pallas)."""
    from opencl_ray_tracer.cli import main

    out = str(tmp_path / "fit.png")
    rc = main([
        "fit", "--scene", "1", "--shading", "phong", "--camera", "pinhole",
        "--backend", "xla", "--steps", "2",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
        "--out", out,
    ])
    assert rc == 0
    printed = capsys.readouterr().out
    # the target must actually contain the scene: a cropped-out-of-frame
    # target fits against black and reports loss 0.000000 from step 0
    assert "loss: 0.000000 ->" not in printed
    import os

    assert os.path.exists(out)
    from opencl_ray_tracer.parallel.checkpoint import latest_checkpoint

    assert latest_checkpoint(str(tmp_path / "ck")) is not None
