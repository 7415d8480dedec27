"""Two-process jax.distributed worker (run by tests/test_distributed.py).

Each process owns 4 virtual CPU devices; jax.distributed.initialize joins
them into one 8-device global mesh. The worker runs ONE sharded
inverse-rendering train step (parallel/train.py — scene replicated, target
rows sharded, scene-grad psum across the mesh) and prints a JSON line with
the loss and a post-step scene checksum. The test asserts both processes
agree with each other AND with a single-process 8-device run — making
parallel/distributed.py's multi-process path live, tested code
(SURVEY.md §4's fake-backend strategy extended across process boundaries).
"""

import json
import os
import sys

# Must be set before jax import (the test sets them in the child env too;
# keep here for standalone runs).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> None:
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from opencl_ray_tracer.parallel.distributed import initialize

    initialize(
        coordinator_address=coord, num_processes=n_proc, process_id=pid
    )
    assert jax.process_count() == n_proc, jax.process_count()
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 global devices, got {len(devs)}"

    from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer.parallel.train import (
        init_train_state,
        make_train_step,
    )
    from opencl_ray_tracer.scene import random_scene
    from opencl_ray_tracer.diff.soft import render_soft_jit
    from opencl_ray_tracer.parallel.mesh import IMAGE_AXIS

    W, H = 128, 64
    cfg = RenderConfig(
        width=W, height=H, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.5,
    )
    cam = legacy_ortho_camera()
    scene = random_scene(4, 2, seed=5, bounds=(float(W), float(H)))
    target_scene = random_scene(4, 2, seed=6, bounds=(float(W), float(H)))
    # deterministic target, computed identically on every process
    import jax.numpy as jnp

    target_np = np.asarray(
        render_soft_jit(
            target_scene, cam, jnp.float32(1.0), jnp.float32(0.5),
            height=H, width=W, shading="lambert",
        )
    )

    mesh = Mesh(np.asarray(devs).reshape(8), (IMAGE_AXIS,))
    shard = NamedSharding(mesh, P(IMAGE_AXIS, None, None))
    rep_cache = {}

    def replicated(x):
        x = np.asarray(x)
        key = (x.shape, str(x.dtype))
        s = rep_cache.setdefault(key, NamedSharding(mesh, P()))
        return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

    target = jax.make_array_from_callback(
        target_np.shape, shard, lambda idx: target_np[idx]
    )
    opt = optax.sgd(1e-4)
    state = jax.tree_util.tree_map(replicated, init_train_state(scene, opt))
    step = make_train_step(cam, cfg, opt, mesh=mesh)
    state, loss = step(state, target)
    checksum = float(
        np.asarray(state.scene.sphere_origin.addressable_data(0)).sum()
    )
    print(json.dumps({
        "pid": pid,
        "loss": float(np.asarray(loss.addressable_data(0))),
        "scene_checksum": checksum,
        "process_count": jax.process_count(),
        "global_devices": len(devs),
    }), flush=True)


if __name__ == "__main__":
    main()
