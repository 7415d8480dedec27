"""Two-process jax.distributed validation.

Spawns 2 subprocesses with 4 virtual CPU devices each and a localhost
coordinator; each runs one sharded train step over the joint 8-device mesh
(tests/distributed_worker.py). Asserts (a) both processes produce identical
replicated results, and (b) they match a single-process 8-device run of the
same step — the honest stand-in for BASELINE config 5's 2-host scaling
contract without pod hardware."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_reference():
    """The same one train step on this process's own 8-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer.diff.soft import render_soft_jit
    from opencl_ray_tracer.parallel.mesh import IMAGE_AXIS
    from opencl_ray_tracer.parallel.train import (
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer.scene import random_scene

    W, H = 128, 64
    cfg = RenderConfig(
        width=W, height=H, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
    )
    cam = legacy_ortho_camera()
    scene = random_scene(4, 2, seed=5, bounds=(float(W), float(H)))
    target_scene = random_scene(4, 2, seed=6, bounds=(float(W), float(H)))
    target = render_soft_jit(
        target_scene, cam, jnp.float32(1.0), jnp.float32(0.5),
        height=H, width=W, shading="lambert",
    )
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), (IMAGE_AXIS,))
    opt = optax.sgd(1e-4)
    state = init_train_state(scene, opt)
    step = make_train_step(cam, cfg, opt, mesh=mesh)
    state, loss = step(state, jax.device_put(target))
    return float(loss), float(np.asarray(state.scene.sphere_origin).sum())


def test_two_process_distributed_train_step():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "PYTHONPATH": repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env_base,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        outs.append(json.loads(line))

    a, b = outs
    assert a["process_count"] == 2 and a["global_devices"] == 8
    # replicated results must be identical across processes
    assert a["loss"] == b["loss"]
    assert a["scene_checksum"] == b["scene_checksum"]

    ref_loss, ref_checksum = _single_process_reference()
    # same math, different collective schedules: f32-tolerance agreement
    np.testing.assert_allclose(a["loss"], ref_loss, rtol=1e-5)
    np.testing.assert_allclose(
        a["scene_checksum"], ref_checksum, rtol=1e-5, atol=1e-5
    )
