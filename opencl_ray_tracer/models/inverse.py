"""Inverse rendering: fit scene parameters to a target image.

The capstone model family (BASELINE.json config 5): given a target
framebuffer, optimize sphere centers/radii/colours, cube vertices, and light
parameters by gradient descent through the soft differentiable renderer,
with the distributed train step from parallel/train.py.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from opencl_ray_tracer.camera import Camera, legacy_ortho_camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.parallel import (
    init_train_state,
    make_train_step,
    replicate,
    shard_rows,
)
from opencl_ray_tracer.utils.log import log_info

# Leaves whose names make sense to optimize by default (geometry + colour +
# light); leave e.g. nothing frozen when filter is None.
SPHERE_PARAMS = ("sphere_origin", "sphere_radius", "sphere_colour")


def param_filter_from_names(names) -> Callable:
    names = tuple(names)

    def fltr(path) -> bool:
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        return any(k in names for k in keys)

    return fltr


def perturb_scene(scene, seed: int = 0, origin_sigma: float = 20.0,
                  radius_scale: float = 0.25, colour_sigma: float = 0.15):
    """Jittered copy of a scene — the standard starting point for an
    inverse-rendering recovery run (cli fit, examples). Sphere origins get
    Gaussian offsets, radii a multiplicative jitter, colours RGB noise;
    triangles/lights are left exact (fit with trainable=SPHERE_PARAMS)."""
    import dataclasses

    rng = np.random.default_rng(seed)
    so = np.asarray(scene.sphere_origin)
    sr = np.asarray(scene.sphere_radius)
    sc = np.asarray(scene.sphere_colour)
    so = so + rng.normal(0.0, origin_sigma, so.shape).astype(np.float32)
    sr = sr * (1.0 + rng.uniform(-radius_scale, radius_scale, sr.shape)).astype(
        np.float32
    )
    sc = sc.copy()
    if sc.size:
        sc[:, :3] = np.clip(
            sc[:, :3] + rng.normal(0.0, colour_sigma, sc[:, :3].shape), 0.05, 1.0
        ).astype(np.float32)
    return dataclasses.replace(
        scene,
        sphere_origin=jnp.asarray(so),
        sphere_radius=jnp.asarray(sr),
        sphere_colour=jnp.asarray(sc),
    )


def fit_scene(
    init_scene,
    target,
    camera: Optional[Camera] = None,
    config: Optional[RenderConfig] = None,
    steps: int = 200,
    learning_rate: float = 0.5,
    trainable: Optional[tuple] = None,
    mesh=None,
    log_every: int = 50,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
):
    """Gradient-fit `init_scene` to `target` (H, W, 4 in the 0..255 domain).

    Returns (scene, losses). Uses Adam; `trainable` optionally restricts to
    named scene fields (e.g. SPHERE_PARAMS).

    With `checkpoint_dir`, the TrainState (scene + optimizer + step) is
    saved every `checkpoint_every` steps and at the end, and a killed run
    RESUMES from the latest checkpoint on the next call — the checkpoint /
    resume subsystem (parallel/checkpoint.py) in its production seat
    (SURVEY.md §5; the reference has no analogue beyond the PNG dump).
    """
    config = config or RenderConfig(
        width=int(target.shape[1]),
        height=int(target.shape[0]),
        shading="lambert",
        soft=True,
        framebuffer_dtype="float",
    )
    camera = camera or legacy_ortho_camera()
    if mesh is None:
        from opencl_ray_tracer.parallel import mesh_from_config

        mesh = mesh_from_config(config)

    optimizer = optax.adam(learning_rate)
    fltr = param_filter_from_names(trainable) if trainable else None
    step = make_train_step(camera, config, optimizer, mesh=mesh, param_filter=fltr)

    target = jnp.asarray(np.asarray(target, np.float32))
    target_sharded = shard_rows(target, mesh)
    state = init_train_state(replicate(init_scene, mesh), optimizer)
    if checkpoint_dir:
        from opencl_ray_tracer.parallel.checkpoint import (
            resume_or_init,
            save_checkpoint,
        )

        state = resume_or_init(checkpoint_dir, state)
    start = int(state.step)

    losses = []
    for i in range(start, steps):
        state, loss = step(state, target_sharded)
        if i % log_every == 0 or i == steps - 1:
            lv = float(loss)
            losses.append(lv)
            log_info("fit_scene step %d loss %.6f", i, lv)
        if checkpoint_dir and (
            (i + 1) % checkpoint_every == 0 or i == steps - 1
        ):
            save_checkpoint(checkpoint_dir, state)
    return state.scene, losses
