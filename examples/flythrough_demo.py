#!/usr/bin/env python
"""Pinhole camera flythrough — the interactive-renderer showcase.

Orbits a real pinhole camera around scene 2 and renders every frame
through the platform's renderer (on a GPU the projective tiled+culled
Pallas kernel; on the CPU the XLA renderer), reporting sustained
frames/second and rays/second (the reference app renders one frame per
keypress; this is the same pipeline at animation rates). Optionally dumps
PNG frames and/or plays the sequence in the terminal as 24-bit ANSI
half-blocks (utils/display.py).

Run on a GPU: python examples/flythrough_demo.py --frames 120
Tiny on CPU: JAX_PLATFORMS=cpu python examples/flythrough_demo.py \\
                 --frames 4 --width 640 --height 480
"""

import argparse
import math
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--scene", type=int, default=2)
    ap.add_argument("--shading", default="phong",
                    choices=["legacy", "lambert", "phong"])
    ap.add_argument("--radius", type=float, default=600.0)
    ap.add_argument("--png-prefix", default="",
                    help="write frames as <prefix>NNN.png")
    ap.add_argument("--ansi", action="store_true",
                    help="play the frames in the terminal")
    args = ap.parse_args()

    import jax

    from opencl_ray_tracer import (
        RenderConfig,
        create_scene,
        pinhole_camera,
        render,
    )
    from opencl_ray_tracer.utils import show, write_png

    w, h = args.width, args.height
    cfg = RenderConfig(
        width=w, height=h, shading=args.shading,
        shadows=args.shading == "phong",
        framebuffer_dtype="int" if args.shading == "legacy" else "float",
    )
    scene = create_scene(args.scene, seed=0)
    center = (320.0, 240.0, -60.0)  # scene 2 lives in the 640x480 view box

    def camera_at(angle: float):
        return pinhole_camera(
            position=(
                center[0] + args.radius * math.sin(angle),
                center[1] - 120.0,
                center[2] + args.radius * math.cos(angle),
            ),
            look_at=center,
            fov_degrees=55.0,
            width=w,
            height=h,
        )

    # warm up / compile on frame 0's camera
    fb = render(scene, camera_at(0.0), cfg)
    jax.block_until_ready(fb)

    t0 = time.perf_counter()
    for i in range(args.frames):
        angle = 2.0 * math.pi * i / max(args.frames, 1)
        fb = render(scene, camera_at(angle), cfg)
        jax.block_until_ready(fb)
        if args.png_prefix:
            write_png(f"{args.png_prefix}{i:03d}.png", fb)
        if args.ansi:
            print(f"\x1b[H\x1b[2J-- frame {i} --")
            show(fb)
    dt = time.perf_counter() - t0
    fps = args.frames / dt
    print(
        f"{args.frames} frames at {w}x{h}: {dt:.2f}s -> {fps:.1f} fps "
        f"({fps * w * h:.3e} rays/s sustained, incl. host loop)"
    )


if __name__ == "__main__":
    main()
