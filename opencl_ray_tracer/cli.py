"""CLI — the framework's main() (the reference's RayTrace/main.cpp role).

Subcommands:

  render    render a scene to PNG on a chosen backend
  compare   the reference app's whole purpose: run the same scene on the
            CPU oracle and the accelerated backend, print both wall times
            and the cross-check result (the F1 toggle as a one-shot)
  app       interactive benchmark shell (state machine + input manager)
  bench     rays/s benchmark table across scenes/modes
  fit       inverse-rendering demo: recover a perturbed scene from a target
  devices   device capability dump (openCLInit's platform/device listing)

Usage: python -m opencl_ray_tracer.cli <subcommand> [options]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--scene", type=int, default=1, help="scene number 1-3")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--shading", choices=["legacy", "lambert", "phong"], default="legacy"
    )
    p.add_argument("--shadows", action="store_true")
    p.add_argument(
        "--backend", choices=["reference", "xla", "pallas"], default=None
    )
    p.add_argument("--settings", help="XML or JSON settings/config file")
    p.add_argument("--msaa", type=int, default=None,
                   choices=[0, 1, 2, 4, 8, 16],
                   help="supersampling samples/pixel (overrides settings)")
    p.add_argument("--show", action="store_true",
                   help="print the framebuffer to the terminal "
                        "(24-bit ANSI half-blocks)")
    p.add_argument("--camera", choices=["ortho", "pinhole"], default="ortho",
                   help="legacy shared-direction ortho or a real pinhole")
    p.add_argument("--cam-pos", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-look", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--fov", type=float, default=60.0)


def _config_from(args) -> "RenderConfig":
    from opencl_ray_tracer.config import RenderConfig, Settings

    msaa = 0
    if args.settings:
        if args.settings.endswith(".xml"):
            s = Settings.from_xml(args.settings)
            args.width, args.height = s.width, s.height
            msaa = s.msaa
        else:
            cfg = RenderConfig.from_json(args.settings)
            if args.msaa is not None:
                cfg = cfg.replace(msaa=args.msaa)
            return cfg
    if args.msaa is not None:
        msaa = args.msaa
    fb = "float" if args.shading != "legacy" else "int"
    return RenderConfig(
        width=args.width,
        height=args.height,
        shading=args.shading,
        shadows=args.shadows,
        framebuffer_dtype=fb,
        msaa=msaa,
    ).validate()


def _camera_from(args, cfg):
    from opencl_ray_tracer import legacy_ortho_camera, pinhole_camera

    if args.camera == "pinhole":
        # default close enough that legacy depth-fog (black past t=180,
        # rayTracer.cl:193) still shows the scene
        pos = args.cam_pos or [cfg.width / 2.0, cfg.height / 2.0, 80.0]
        look = args.cam_look or [cfg.width / 2.0, cfg.height / 2.0, -60.0]
        return pinhole_camera(
            position=tuple(pos), look_at=tuple(look),
            fov_degrees=args.fov, width=cfg.width, height=cfg.height,
        )
    return legacy_ortho_camera()


def cmd_render(args) -> int:
    import jax

    from opencl_ray_tracer import create_scene, render
    from opencl_ray_tracer.utils import PerformanceCounter, write_png

    cfg = _config_from(args)
    if getattr(args, "packed", False):
        cfg = cfg.replace(framebuffer_dtype="packed")
    scene = create_scene(args.scene, seed=args.seed)
    cam = _camera_from(args, cfg)
    timer = PerformanceCounter()
    timer.start_counter()
    fb = render(scene, cam, cfg, backend=args.backend)
    jax.block_until_ready(fb)
    us = timer.stop_counter()
    print(f"scene {args.scene} {cfg.width}x{cfg.height} "
          f"backend={args.backend or 'auto'}: {us:.0f} us")
    write_png(args.out, fb)
    print(f"wrote {args.out}")
    if args.show:
        from opencl_ray_tracer.utils import show

        show(fb)
    return 0


def cmd_compare(args) -> int:
    """CPU oracle vs accelerated backend: times + pixel cross-check."""
    import jax

    from opencl_ray_tracer import create_scene, render
    from opencl_ray_tracer.runtime import default_backend
    from opencl_ray_tracer.utils import time_fn

    cfg = _config_from(args)
    scene = create_scene(args.scene, seed=args.seed)
    cam = _camera_from(args, cfg)
    accel = args.backend or default_backend().value

    fb_cpu = render(scene, cam, cfg, backend="reference")
    fb_acc = render(scene, cam, cfg, backend=accel)
    jax.block_until_ready((fb_cpu, fb_acc))

    cpu_stats = time_fn(
        lambda: render(scene, cam, cfg, backend="reference"), iters=3, warmup=1
    )
    acc_stats = time_fn(
        lambda: render(scene, cam, cfg, backend=accel), iters=10, warmup=2
    )

    a, b = np.asarray(fb_cpu), np.asarray(fb_acc)
    if a.dtype == np.int32:
        frac = np.all(a == b, axis=-1).mean()
        check = f"{frac:.4%} pixels identical"
        ok = frac > 0.999
    else:
        close = (np.abs(a - b).max(axis=-1) < 0.5).mean()
        check = f"{close:.4%} pixels within 0.5/255"
        ok = close > 0.999

    n_rays = cfg.width * cfg.height
    print(f"scene {args.scene}  {cfg.width}x{cfg.height}  shading={cfg.shading}")
    print(f"  CPU (reference): {cpu_stats['median_us']:>12.0f} us   "
          f"{n_rays / (cpu_stats['median_us'] / 1e6):.3e} rays/s")
    print(f"  {accel:<15}: {acc_stats['median_us']:>12.0f} us   "
          f"{n_rays / (acc_stats['median_us'] / 1e6):.3e} rays/s")
    print(f"  speedup: {cpu_stats['median_us'] / acc_stats['median_us']:.1f}x")
    print(f"  cross-check: {check} -> {'OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


def cmd_app(args) -> int:
    from opencl_ray_tracer.app import (
        InputManager, MainState, StateManager, run_interactive, run_scripted,
    )

    cfg = _config_from(args)
    manager = StateManager()
    state = MainState(manager, InputManager(), config=cfg,
                      scene_seed=args.seed, display=args.display)
    manager.add_state(state)
    if args.keys:
        for line in run_scripted(manager, list(args.keys.split(","))):
            print(line)
    else:
        run_interactive(manager)
    return 0


def cmd_bench(args) -> int:
    import bench as bench_mod  # repo-root harness

    bench_mod.main(args.bench_args)  # forward e.g. --scene 3 --width 640
    return 0


def cmd_fit(args) -> int:
    """Inverse-rendering capstone on the GENERAL surface: render the chosen
    library scene through the chosen camera/shading as the target, perturb
    its sphere parameters, and recover them by gradient descent through the
    soft differentiable renderer — with optional checkpoint/resume."""
    from opencl_ray_tracer import create_scene
    from opencl_ray_tracer.diff import render_soft
    from opencl_ray_tracer.models.inverse import (
        SPHERE_PARAMS,
        fit_scene,
        perturb_scene,
    )
    from opencl_ray_tracer.utils import write_png

    shading = args.shading if args.shading != "legacy" else "lambert"
    cfg = _config_from(args).replace(
        shading=shading, soft=True, framebuffer_dtype="float",
        tau_depth=1.0, tau_edge=0.5, msaa=0,
        **({"backend": args.backend} if args.backend else {}),
    )
    cam = _camera_from(args, cfg)
    true_scene = create_scene(args.scene, seed=args.seed)
    target = render_soft(true_scene, cam, cfg)
    init = perturb_scene(true_scene, seed=args.seed + 1)
    fitted, losses = fit_scene(
        init, target, camera=cam, config=cfg, steps=args.steps,
        learning_rate=args.lr, trainable=SPHERE_PARAMS,
        log_every=max(args.steps // 10, 1),
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
    )
    err0 = np.abs(
        np.asarray(init.sphere_origin) - np.asarray(true_scene.sphere_origin)
    ).max()
    err1 = np.abs(
        np.asarray(fitted.sphere_origin) - np.asarray(true_scene.sphere_origin)
    ).max()
    print(f"scene {args.scene} camera={args.camera} shading={shading}: "
          f"max origin error {err0:.2f} -> {err1:.2f}")
    if losses:
        print("loss: %.6f -> %.6f" % (losses[0], losses[-1]))
    if args.out:
        write_png(args.out, render_soft(fitted, cam, cfg))
        print(f"wrote {args.out}")
    return 0


def cmd_devices(args) -> int:
    from opencl_ray_tracer.runtime import default_device, describe_devices

    for line in describe_devices():
        print(line)
    print("selected:", default_device())
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="opencl_ray_tracer")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--packed", action="store_true",
                   help="packed int32 framebuffer (fastest Pallas path; "
                        "PNG/display consume the words directly)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("compare", help="CPU vs accelerated comparison")
    _add_common(p)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("app", help="interactive benchmark shell")
    _add_common(p)
    p.add_argument("--keys", help="comma-separated scripted key events")
    p.add_argument("--display", action="store_true",
                   help="re-blit the terminal framebuffer after every "
                        "trace (the per-frame window blit, headless)")
    p.set_defaults(fn=cmd_app)

    p = sub.add_parser("bench", help="rays/s benchmark")
    p.add_argument(
        "bench_args", nargs=argparse.REMAINDER,
        help="forwarded to bench.py (e.g. --scene 3 --width 640 --height 480)",
    )
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="inverse-rendering capstone")
    _add_common(p)
    # the scene library lives in the reference's 640x480 world box
    # (MainState.cpp:419-639): smaller windows would crop the scene out of
    # frame and fit against an empty target
    p.set_defaults(width=640, height=480)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--checkpoint-dir", default="",
                   help="save/resume TrainState checkpoints here")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--out", default="")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("devices", help="device capability dump")
    p.set_defaults(fn=cmd_devices)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
