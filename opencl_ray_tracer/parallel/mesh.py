"""Device mesh + sharded rendering.

The reference has exactly one parallel axis — pixels — mapped to a flat 1-D
OpenCL NDRange on one device (MainState.cpp:858; SURVEY.md §2 parallelism
note). This design extends the same axis across devices:

  intra-device: Pallas grid over pixel tiles          (kernels/fwd_tiled.py)
  inter-device: image ROWS sharded over a 1-D mesh    (this module)
  multi-process: same mesh spanning processes via jax.distributed
                 (distributed.py)

The scene is REPLICATED per device (it is ~70 KB — the broadcast the
reference does with read-only buffers), the framebuffer stays
device-resident in row shards (no gather except for display/PNG), and the
forward pass needs ZERO inter-device communication because pixels are
independent. The backward pass all-reduces scene-parameter gradients with
one psum (parallel/train.py). The cards of one host are joined all to all,
so the flat mesh is the layout for them.

Ray generation is what makes row-sharding free: cameras are affine ray
bundles (camera.py), so shard i just offsets the bundle origin by its first
row — no (H, W) index arrays ever exist.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from opencl_ray_tracer.camera import Camera
from opencl_ray_tracer.config import RenderConfig
from opencl_ray_tracer.runtime.backend import Backend, resolve_backend

IMAGE_AXIS = "image"
HOST_AXIS = "host"


def make_mesh(n_devices: Optional[int] = None, axis: str = IMAGE_AXIS) -> Mesh:
    """1-D mesh over the image axis (the only axis this workload has)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(
    hosts: int, chips: int,
    host_axis: str = HOST_AXIS, axis: str = IMAGE_AXIS,
) -> Mesh:
    """2-D (processes, devices) mesh for multi-process runs. Image rows
    shard over BOTH axes (the workload still has one parallel dimension —
    pixels); the axes let the backward reduce the scene grads within each
    process first and then across processes (parallel/train.py).
    jax.devices() is contiguous per process under jax.distributed, so the
    reshape puts each mesh row on one process' devices."""
    devs = jax.devices()
    n = hosts * chips
    if n > len(devs):
        raise ValueError(
            f"mesh ({hosts}, {chips}) needs {n} devices; only "
            f"{len(devs)} visible"
        )
    return Mesh(
        np.array(devs[:n]).reshape(hosts, chips), (host_axis, axis)
    )


def mesh_row_axes(mesh: Mesh, axis: str = IMAGE_AXIS):
    """The mesh axes image rows shard over — ALL of the mesh's axes, in
    mesh order (pixels are this workload's only parallel dimension, so
    every axis, whatever its name, shards rows; the 2-D mesh's outer
    axis rides first = process-major row blocks)."""
    del axis  # kept for signature compatibility; all axes shard rows
    return tuple(mesh.axis_names)


def mesh_n_shards(mesh: Mesh, axis: str = IMAGE_AXIS) -> int:
    n = 1
    for a in mesh_row_axes(mesh, axis):
        n *= mesh.shape[a]
    return n


def mesh_from_config(config: RenderConfig, axis: str = IMAGE_AXIS) -> Mesh:
    """Mesh selected by config.mesh_shape: None = all visible devices on
    the flat image mesh, (n,) = the first n devices, (processes, devices)
    = the 2-D multi-process mesh (make_mesh_2d)."""
    if config.mesh_shape is None:
        return make_mesh(axis=axis)
    dims = [int(d) for d in config.mesh_shape]
    n = 1
    for d in dims:
        n *= d
    avail = len(jax.devices())
    if n > avail:
        raise ValueError(
            f"config.mesh_shape {config.mesh_shape} needs {n} devices; "
            f"only {avail} visible"
        )
    if len(dims) == 2:
        return make_mesh_2d(dims[0], dims[1], axis=axis)
    if len(dims) > 2:
        raise ValueError(
            f"config.mesh_shape {config.mesh_shape}: at most 2 dims "
            f"(processes, devices) — the workload has one parallel axis "
            f"(pixels)"
        )
    return make_mesh(n, axis=axis)


def shift_camera_rows(camera: Camera, row0) -> Camera:
    """Camera for an image slice starting at absolute row `row0`: shift the
    affine bundle along its row derivative. Exact — the shard renders the
    same rays the full camera would."""
    r = jnp.asarray(row0, jnp.float32)
    return dataclasses.replace(
        camera,
        o0=camera.o0 + r * camera.doy,
        d0=camera.d0 + r * camera.ddy,
    )


def _render_rows(scene, camera, h, w, config: RenderConfig):
    """Un-jitted row-block renderer used inside shard_map."""
    # jit-in-jit is inlined during tracing, so the cached jitted entry points
    # are safe to reuse inside shard_map.
    if config.msaa > 1:
        # Honor MSAA per shard: the same supersample-resolve-quantize order
        # as the facade (models/renderer.render), through the exact
        # shift_subpixel camera bundle — so render_sharded(msaa=k) equals
        # the facade's msaa=k output row-for-row.
        from opencl_ray_tracer.models.renderer import MSAA_OFFSETS

        sample_cfg = config.replace(msaa=0, framebuffer_dtype="float")
        acc = None
        for dx, dy in MSAA_OFFSETS[config.msaa]:
            img = _render_rows(
                scene, camera.shift_subpixel(dx, dy), h, w, sample_cfg
            )
            acc = img if acc is None else acc + img
        out = acc * (1.0 / config.msaa)
        if config.framebuffer_dtype == "int":
            out = jnp.round(out).astype(jnp.int32)
        elif config.framebuffer_dtype == "packed":
            from opencl_ray_tracer.ops.shading import pack_framebuffer_words

            out = pack_framebuffer_words(jnp.round(out))
        return out
    use_kernels = resolve_backend(config.backend) == Backend.PALLAS
    if config.soft:
        if use_kernels:
            from opencl_ray_tracer.kernels.soft_tiled import (
                render_soft_tiled,
            )

            return render_soft_tiled(
                scene, camera, config.replace(height=h, width=w)
            )
        from opencl_ray_tracer.diff.soft import render_soft_jit

        return render_soft_jit(
            scene,
            camera,
            jnp.float32(config.tau_depth),
            jnp.float32(config.tau_edge),
            height=h,
            width=w,
            shading=config.shading,
            shadows=config.shadows,
        )
    if use_kernels:
        # Tiled+culled kernel per shard: the shifted camera's origin offset
        # moves the shard's tile rects into world coordinates at binning
        # time (fwd_tiled._bin_prims offs), so each device culls against its
        # own row block. Pinhole shards bin through their shifted camera's
        # projection directly.
        from opencl_ray_tracer.kernels.fwd_tiled import render_tiled

        return render_tiled(
            scene, camera, config.replace(height=h, width=w)
        )
    from opencl_ray_tracer.models.xla_backend import render_xla_jit

    rgba = render_xla_jit(
        scene,
        camera,
        height=h,
        width=w,
        shading=config.shading,
        shadows=config.shadows,
        as_int=config.framebuffer_dtype == "int",
    )
    if config.framebuffer_dtype == "packed":
        from opencl_ray_tracer.ops.shading import pack_framebuffer_words

        return pack_framebuffer_words(rgba)
    return rgba


def render_sharded(
    scene,
    camera: Camera,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    axis: str = IMAGE_AXIS,
) -> jax.Array:
    """Render with image rows sharded across the mesh.

    Returns the full (H, W, 4) framebuffer — or (H, W) packed int32 words
    when config.framebuffer_dtype == "packed" — as a sharded global array
    (row shards live on their devices; host gather only happens if the
    caller pulls it to numpy — the display/PNG path). config.msaa > 1 is
    honored per shard (identical to the facade's supersampling). When no
    `mesh` is passed, config.mesh_shape picks the device count
    (mesh_from_config).
    """
    mesh = mesh or mesh_from_config(config, axis=axis)
    row_axes = mesh_row_axes(mesh, axis)
    n = mesh_n_shards(mesh, axis)
    h, w = config.height, config.width
    if h % n:
        raise ValueError(f"height {h} not divisible by mesh size {n}")
    h_local = h // n

    spec_repl = P()
    out_spec = (
        P(row_axes, None) if config.framebuffer_dtype == "packed"
        else P(row_axes, None, None)
    )

    @partial(jax.jit, static_argnums=())
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_repl, spec_repl),
        out_specs=out_spec,
        check_vma=False,
    )
    def run(scene_, camera_):
        idx = jax.lax.axis_index(row_axes)
        cam_local = shift_camera_rows(camera_, idx * h_local)
        return _render_rows(scene_, cam_local, h_local, w, config)

    return run(scene, camera)


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated on the mesh (the scene broadcast)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_rows(array, mesh: Mesh, axis: str = IMAGE_AXIS):
    """Shard a (H, ...) array by rows over the mesh (e.g. a target image).
    On a 2-D mesh, rows shard over (process, image) jointly."""
    spec = P(mesh_row_axes(mesh, axis), *([None] * (array.ndim - 1)))
    return jax.device_put(array, NamedSharding(mesh, spec))
