"""Distributed differentiable-rendering train step.

The inverse-rendering capstone (BASELINE.json config 5): fit scene parameters
to a target image by gradient descent, scaled over the device mesh:

  - image rows SHARDED over the mesh ('image' axis)
  - scene + optimizer state REPLICATED
  - forward+backward run per shard on local rows (zero communication —
    pixels are independent)
  - scene-parameter grads are partial sums over local pixels, so one
    jax.lax.psum over the mesh axis completes them: this is THE collective
    of the workload. XLA overlaps it with the remaining backward
    computation where profitable.

The train step is a single pjit/shard_map program: one compile, one launch
per step, exactly the XLA execution model the kernel guide prescribes.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from opencl_ray_tracer.camera import Camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.parallel.mesh import (
    IMAGE_AXIS,
    mesh_from_config,
    mesh_n_shards,
    mesh_row_axes,
    shift_camera_rows,
)
from opencl_ray_tracer.diff.soft import render_soft_jit
from opencl_ray_tracer.kernels.soft_tiled import render_soft_tiled
from opencl_ray_tracer.runtime.backend import Backend, resolve_backend


class TrainState(NamedTuple):
    scene: object          # Scene pytree (all leaves trainable)
    opt_state: object
    step: jax.Array


def make_train_step(
    camera: Camera,
    config: RenderConfig,
    optimizer: optax.GradientTransformation,
    mesh: Optional[Mesh] = None,
    axis: str = IMAGE_AXIS,
    param_filter: Optional[Callable] = None,
) -> Callable:
    """Build the jitted sharded train step.

    Returns step(state: TrainState, target: (H, W, 4) row-sharded float32)
    -> (state, loss). `param_filter(path_tuple) -> bool` optionally freezes
    leaves (grads zeroed) — e.g. train only sphere parameters.
    """
    if config.msaa > 1:
        # Loud rejection, not silent ignoring: the
        # train loss is defined on 1-sample soft renders; supersampled
        # training would need the loss averaged over sample offsets.
        raise ValueError(
            "make_train_step does not support msaa > 1; render the target "
            "at msaa=0 or average sample offsets in a custom loss"
        )
    mesh = mesh or mesh_from_config(config, axis=axis)
    row_axes = mesh_row_axes(mesh, axis)
    n = mesh_n_shards(mesh, axis)
    h, w = config.height, config.width
    if h % n:
        raise ValueError(f"height {h} not divisible by mesh size {n}")
    h_local = h // n
    inv_npix = 1.0 / (h * w * 3.0)
    # The engine: the tiled Pallas soft fwd+bwd kernels (all shading modes
    # native — no downgrades). backend="xla"/"reference" selects the dense
    # jnp twin, the oracle for cross-checks (and the CPU default).
    use_pallas = resolve_backend(config.backend) == Backend.PALLAS
    local_cfg = config.replace(
        height=h_local, width=w, soft=True, framebuffer_dtype="float"
    )

    def local_loss(scene, camera_, target_local, row0):
        cam_local = shift_camera_rows(camera_, row0)
        if use_pallas:
            img = render_soft_tiled(scene, cam_local, local_cfg)
        else:
            img = render_soft_jit(
                scene,
                cam_local,
                jnp.float32(config.tau_depth),
                jnp.float32(config.tau_edge),
                height=h_local,
                width=w,
                shading=config.shading,
                shadows=config.shadows,
            )
        diff = (img[..., :3] - target_local[..., :3]) * (1.0 / 255.0)
        return jnp.sum(diff * diff) * inv_npix

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(row_axes, None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def sharded_grad(scene, camera_, opt_dummy, target_local):
        idx = jax.lax.axis_index(row_axes)
        loss, grads = jax.value_and_grad(local_loss)(
            scene, camera_, target_local, idx * h_local
        )

        # THE collective: complete the scene-param grads across row shards.
        # On the 2-D (process, image) mesh of a multi-process run the
        # reduction goes axis by axis: within each process first, then one
        # psum of the already-reduced O(scene) payload across processes.
        def allreduce(v):
            for a in reversed(row_axes):  # inner (in-process) axis first
                v = jax.lax.psum(v, a)
            return v

        loss = allreduce(loss)
        grads = jax.tree_util.tree_map(allreduce, grads)
        return loss, grads

    @jax.jit
    def step(state: TrainState, target) -> tuple:
        loss, grads = sharded_grad(state.scene, camera, state.opt_state, target)
        if param_filter is not None:
            flat, treedef = jax.tree_util.tree_flatten_with_path(grads)
            flat = [
                (p, g if param_filter(p) else jnp.zeros_like(g)) for p, g in flat
            ]
            grads = jax.tree_util.tree_unflatten(treedef, [g for _, g in flat])
        updates, opt_state = optimizer.update(grads, state.opt_state, state.scene)
        scene = optax.apply_updates(state.scene, updates)
        return TrainState(scene, opt_state, state.step + 1), loss

    return step


def init_train_state(scene, optimizer: optax.GradientTransformation) -> TrainState:
    return TrainState(
        scene=scene,
        opt_state=optimizer.init(scene),
        step=jnp.zeros((), jnp.int32),
    )
