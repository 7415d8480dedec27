#!/usr/bin/env python
"""Inverse-rendering capstone demo (BASELINE.json config 5, single-host cut).

Renders a target image from a ground-truth scene with the soft renderer,
perturbs the scene, then recovers sphere geometry + colours by gradient
descent through the differentiable renderer — image rows sharded across all
local devices, scene grads psum'd over the mesh.

Run on a GPU:        python examples/inverse_rendering_demo.py
Run on 8 fake chips: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
                     python examples/inverse_rendering_demo.py --width 256 --height 128
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out-prefix", default="/tmp/inverse_demo")
    args = ap.parse_args()

    import jax

    from opencl_ray_tracer import RenderConfig, legacy_ortho_camera
    from opencl_ray_tracer.diff import render_soft
    from opencl_ray_tracer.models.inverse import SPHERE_PARAMS, fit_scene
    from opencl_ray_tracer.parallel import make_mesh
    from opencl_ray_tracer.scene import Scene
    from opencl_ray_tracer.utils import write_png

    w, h = args.width, args.height
    cfg = RenderConfig(
        width=w, height=h, shading="lambert", soft=True,
        framebuffer_dtype="float", tau_depth=1.0, tau_edge=0.75,
    )
    cam = legacy_ortho_camera()
    mesh = make_mesh()
    print(f"devices: {jax.devices()}  mesh: {mesh.shape}")

    true_scene = Scene.build(
        sphere_origin=[
            [w * 0.3, h * 0.5, -50.0],
            [w * 0.65, h * 0.4, -70.0],
        ],
        sphere_radius=[h * 0.22, h * 0.3],
        sphere_colour=[[1.0, 0.25, 0.2, 255.0], [0.2, 0.4, 1.0, 255.0]],
    )
    target = render_soft(true_scene, cam, cfg)
    write_png(f"{args.out_prefix}_target.png", target)

    init_scene = Scene.build(
        sphere_origin=[
            [w * 0.38, h * 0.42, -50.0],
            [w * 0.58, h * 0.52, -70.0],
        ],
        sphere_radius=[h * 0.16, h * 0.24],
        sphere_colour=[[0.7, 0.5, 0.4, 255.0], [0.4, 0.4, 0.7, 255.0]],
    )
    write_png(f"{args.out_prefix}_init.png", render_soft(init_scene, cam, cfg))

    fitted, losses = fit_scene(
        init_scene, target, camera=cam, config=cfg, steps=args.steps,
        learning_rate=0.5, trainable=SPHERE_PARAMS, mesh=mesh, log_every=25,
    )
    write_png(f"{args.out_prefix}_fitted.png", render_soft(fitted, cam, cfg))

    print("\ntrue origins:\n", np.asarray(true_scene.sphere_origin))
    print("fitted origins:\n", np.asarray(fitted.sphere_origin))
    print("true radii:", np.asarray(true_scene.sphere_radius))
    print("fitted radii:", np.asarray(fitted.sphere_radius))
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}")
    print(f"wrote {args.out_prefix}_{{target,init,fitted}}.png")


if __name__ == "__main__":
    main()
