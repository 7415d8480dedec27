#!/usr/bin/env python
"""Benchmark harness for the GPU. Prints ONE JSON line on stdout:

  {"metric": ..., "value": N, "unit": "rays/s", "device": {...}, "rows": {...}}

Headline metric (BASELINE.md): primary rays/s at 1080p, forward, on the
BASELINE.json config-2 scene (10 spheres + 1 cube, Phong + hard shadows),
tiled Pallas kernel emitting the PACKED int32 framebuffer (the PNG/display
byte stream). `rows` holds every measured row in microseconds per frame
(or per fwd+bwd step): each hand-written kernel beside the plain XLA form
of the same computation (models/xla_backend for the forward, the dense
diff/soft twin for fwd+bwd), through the same timing harness
(opencl_ray_tracer/bench_util.py).

The table goes to stderr. A failed row fails the run: the process exits
non-zero and prints no result. So does a process without a GPU.

  python bench.py                 # all rows
  python bench.py --skip-context  # headline fwd and fwd+bwd rows only
  python bench.py --scene 3       # one library scene, forward
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera, pinhole_camera
from opencl_ray_tracer.bench_util import (
    device_frame_time_us,
    device_step_time_us,
    median_spread,
)
from opencl_ray_tracer.diff.soft import render_soft_jit
from opencl_ray_tracer.kernels.fwd_tiled import bin_scene, render_tiled_packed
from opencl_ray_tracer.kernels.soft_tiled import _bin_soft, render_soft_tiled
from opencl_ray_tracer.models.xla_backend import render_xla_jit
from opencl_ray_tracer.scene import create_scene, random_scene
from opencl_ray_tracer.utils.profiling import device_peaks, sol_fraction_ops

# Per-pixel post-hit shading cost of the PHONG+SHADOWS tiled kernel, for
# the ALU side of the SOL model (instruction count of fwd_tiled's shading
# phase, shared-direction camera, 1 light): shadow-ray setup ~14 ops
# (tl/tl2/rsqrt/dist/ld) + hit point & normal ~30 (px/nsx/flip/normalize)
# + diffuse ~25 + specular ~30 (reflect/rdotv/exp-log powf) + finalize ~15
# + int pack ~12, counting rsqrt/exp/log as 1 op each (an underestimate).
PHONG_SHADING_OPS = 126.0

TARGET_RAYS_PER_S = 1.0e9       # BASELINE.md north-star target
W, H = 1920, 1080


def stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fwd_fn(scene, config, cam, kernel=True, dynamic_bins=False):
    """Frame function camera -> framebuffer: the tiled kernel (bins fixed
    per scene, or rebinned in-graph per frame) or the plain XLA form."""
    packed = jax.device_put(scene.pack())
    if not kernel:
        return lambda c: render_xla_jit(
            scene, c, height=config.height, width=config.width,
            shading=config.shading, shadows=config.shadows, as_int=False,
        )

    def bins_for(c):
        return bin_scene(
            packed, height=config.height, width=config.width,
            k=config.cull_k, shadows=config.shadows,
            shadow_k=config.shadow_cull_k,
            camera=c if c.normalize else None,
        )

    if dynamic_bins:
        return lambda c: render_tiled_packed(packed, c, config,
                                             bins=bins_for(c))
    bins = bins_for(cam)
    if bool(bins.overflow):
        raise RuntimeError(f"cull_k={config.cull_k} overflows: the row would "
                           f"time the XLA fallback, not the kernel")
    return lambda c: render_tiled_packed(packed, c, config, bins=bins)


def fwd_bwd_fn(scene, config, cam, kernel=True):
    """Step function camera -> scalar: loss and its grad w.r.t. every scene
    leaf, all of which are consumed so XLA cannot prune any of the
    backward."""
    if kernel:
        bins = _bin_soft(scene.pack(), jnp.float32(config.tau_edge), cam,
                         height=config.height, width=config.width,
                         k=config.cull_k, shadows=config.shadows,
                         shadow_k=config.shadow_cull_k)
        if bool(bins.overflow):
            raise RuntimeError(
                f"cull_k={config.cull_k}/shadow_cull_k={config.shadow_cull_k}"
                f" overflows: the row would time the dense XLA fallback, not "
                f"the kernels")
    scene = jax.device_put(scene)

    def render(s, c):
        if kernel:
            return render_soft_tiled(s, c, config)
        return render_soft_jit(
            s, c, jnp.float32(config.tau_depth), jnp.float32(config.tau_edge),
            height=config.height, width=config.width,
            shading=config.shading, shadows=config.shadows,
        )

    def step(c):
        val, g = jax.value_and_grad(
            lambda s: jnp.mean(render(s, c)[..., :3] ** 2)
        )(scene)
        return val + sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(g))

    return step


def train_step_us(scene, config, n_steps=10):
    """make_train_step on a one-device mesh: soft fwd+bwd inside shard_map
    + psum + adam, optimizer state carried step to step."""
    import time

    import optax

    from opencl_ray_tracer.parallel import (
        init_train_state,
        make_mesh,
        make_train_step,
        replicate,
        shard_rows,
    )

    mesh = make_mesh(1)
    optimizer = optax.adam(1e-3)
    step = make_train_step(legacy_ortho_camera(), config, optimizer, mesh=mesh)
    target = shard_rows(
        jnp.zeros((config.height, config.width, 4), jnp.float32), mesh
    )
    state0 = init_train_state(replicate(scene, mesh), optimizer)

    @jax.jit
    def run(state):
        def body(s, _):
            return step(s, target)

        return jax.lax.scan(body, state, None, length=n_steps)[1][-1]

    jax.block_until_ready(run(state0))
    samples = []
    for _ in range(3):
        t0 = time.perf_counter_ns()
        jax.block_until_ready(run(state0))
        samples.append((time.perf_counter_ns() - t0) / 1e3 / n_steps)
    return sorted(samples)[1]


def parity(cam) -> dict:
    """The F1 cross-check (MainState.cpp:137-154 role) as numbers: scene 1
    through the tiled kernel vs the CPU oracle, and soft gradients of the
    kernel pair vs the dense twin."""
    from opencl_ray_tracer.kernels.fwd_tiled import render_tiled
    from opencl_ray_tracer.ref import render_reference

    scene = create_scene(1)
    cfg = RenderConfig(width=640, height=480, shading="legacy")
    a = render_tiled(scene, cam, cfg)
    b = render_reference(scene, cam, cfg)
    out = {"parity_legacy_frac_identical":
           float(jnp.mean(jnp.all(a == b, axis=-1)))}

    cfg_s = RenderConfig(width=256, height=128, shading="phong", shadows=True,
                         soft=True, framebuffer_dtype="float",
                         tau_depth=1.0, tau_edge=0.5)
    loss = lambda fn: jax.grad(lambda s: jnp.mean(fn(s)[..., :3] ** 2))
    gk = loss(lambda s: render_soft_tiled(s, cam, cfg_s))(scene)
    with jax.default_matmul_precision("highest"):
        gj = loss(lambda s: render_soft_jit(
            s, cam, jnp.float32(1.0), jnp.float32(0.5), height=128,
            width=256, shading="phong", shadows=True,
        ))(scene)
    err = max(
        float(jnp.max(jnp.abs(x - y)) / (jnp.max(jnp.abs(y)) + 1e-20))
        for x, y in zip(jax.tree_util.tree_leaves(gk),
                        jax.tree_util.tree_leaves(gj))
        if x.size
    )
    out["parity_soft_grad_rel_err"] = err
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", type=int, default=None,
                    help="bench a library scene (1-3) instead of the matrix")
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--shading", default="phong",
                    choices=["legacy", "lambert", "phong"])
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--cull-k", type=int, default=None)
    ap.add_argument("--skip-context", action="store_true",
                    help="headline fwd + fwd/bwd rows only")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's device is {dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    gpu = card()
    stderr(f"# device: {device} | {gpu}")
    wid, hgt = args.width, args.height
    cam = legacy_ortho_camera()
    rows = {}

    def row(label, us):
        rows[label] = us
        stderr(f"# {label}: {us:.1f} us -> {wid * hgt / (us / 1e6):.3e} rays/s")
        return us

    if args.scene is not None:
        scene = create_scene(args.scene, seed=0)
        cfg = RenderConfig(
            width=wid, height=hgt, shading=args.shading,
            shadows=not args.no_shadows, framebuffer_dtype="packed",
            **({"cull_k": args.cull_k} if args.cull_k else {}),
        )
        us = row(f"scene{args.scene}_{args.shading}_fwd",
                 device_frame_time_us(fwd_fn(scene, cfg, cam), cam))
        print(json.dumps({
            "metric": f"rays_per_s_scene{args.scene}_{args.shading}_{wid}x{hgt}",
            "value": wid * hgt / (us / 1e6), "unit": "rays/s",
            "device": device, "card": gpu,
        }))
        return

    bounds = (float(wid) - 10, float(hgt) - 10)
    scene_hl = random_scene(10, 1, seed=0, bounds=bounds)
    scene_st = random_scene(100, 100, seed=0, bounds=bounds)
    cfg_hl = RenderConfig(width=wid, height=hgt, shading="phong",
                          shadows=True, framebuffer_dtype="packed")
    cfg_st = RenderConfig(width=wid, height=hgt, shading="legacy",
                          framebuffer_dtype="packed", cull_k=96)
    cfg_soft = RenderConfig(width=wid, height=hgt, shading="phong",
                            shadows=True, soft=True, framebuffer_dtype="float",
                            tau_depth=1.0, tau_edge=0.5)
    cfg_soft_st = cfg_soft.replace(cull_k=96, shadow_cull_k=136)

    us, us_min, us_max = median_spread(
        device_frame_time_us(fwd_fn(scene_hl, cfg_hl, cam), cam, n_frames=200)
        for _ in range(3)
    )
    row("fwd_headline_kernel", us)
    stderr(f"# headline spread over 3 runs: [{us_min:.1f}, {us_max:.1f}] us")
    # SOL context: the slots the kernel executes (per-tile candidate counts,
    # primary + per-light shadow, averaged over pixels) weighted by their
    # op counts, plus shading on the pixels of non-empty tiles
    cnts = np.asarray(bin_scene(
        scene_hl.pack(), height=hgt, width=wid, k=cfg_hl.cull_k,
        shadows=True, shadow_k=cfg_hl.shadow_cull_k,
    ).counts)
    ops_w = np.array([15.0, 16.0] + [22.0, 16.0] * ((cnts.shape[1] - 2) // 2))
    sol = sol_fraction_ops(
        us, wid * hgt,
        intersection_ops_per_pixel=float((cnts * ops_w).sum(1).mean()),
        shading_ops_per_pixel=PHONG_SHADING_OPS,
        shaded_fraction=float((cnts[:, 0] + cnts[:, 1] > 0).mean()),
        bytes_per_pixel=4.0, peaks=device_peaks(dev.device_kind),
    )
    stderr(f"# headline SOL: bound={sol['bound']} ideal={sol['ideal_us']:.1f}us "
           f"achieved_fraction={sol['achieved_fraction']:.3f}")
    row("fwd_headline_xla", device_frame_time_us(
        fwd_fn(scene_hl, cfg_hl, cam, kernel=False), cam, n_frames=20))
    row("fwdbwd_headline_kernel", device_step_time_us(
        fwd_bwd_fn(scene_hl, cfg_soft, cam), cam, n_frames=20))
    row("fwdbwd_headline_xla", device_step_time_us(
        fwd_bwd_fn(scene_hl, cfg_soft, cam, kernel=False), cam, n_frames=3))

    if not args.skip_context:
        row("fwd_stress_kernel", device_frame_time_us(
            fwd_fn(scene_st, cfg_st, cam), cam, n_frames=100))
        row("fwd_stress_xla", device_frame_time_us(
            fwd_fn(scene_st, cfg_st, cam, kernel=False), cam, n_frames=5))
        w4, h4 = 3840, 2160
        cfg_4k = cfg_st.replace(width=w4, height=h4)
        scene_4k = random_scene(100, 100, seed=2,
                                bounds=(float(w4) - 10, float(h4) - 10))
        row("fwd_stress_4k_kernel", device_frame_time_us(
            fwd_fn(scene_4k, cfg_4k, cam), cam, n_frames=50))
        row("fwdbwd_stress_kernel", device_step_time_us(
            fwd_bwd_fn(scene_st, cfg_soft_st, cam), cam, n_frames=10))
        row("fwdbwd_stress_xla", device_step_time_us(
            fwd_bwd_fn(scene_st, cfg_soft_st, cam, kernel=False), cam, n_frames=1,
            reps=3))
        cam_ph = pinhole_camera(
            position=(wid / 2.0, hgt / 2.0, 900.0),
            look_at=(wid / 2.0, hgt / 2.0, -85.0),
            fov_degrees=60.0, width=wid, height=hgt,
        )
        row("fwd_headline_pinhole_kernel", device_frame_time_us(
            fwd_fn(scene_hl, cfg_hl, cam_ph), cam_ph, n_frames=200))
        row("fwd_headline_pinhole_dynamic_bins", device_frame_time_us(
            fwd_fn(scene_hl, cfg_hl, cam_ph, dynamic_bins=True), cam_ph,
            n_frames=100))
        row("train_step_headline", train_step_us(scene_hl, cfg_soft))

    par = parity(cam)
    stderr(f"# parity: {par}")
    print(json.dumps({
        "metric": "primary_rays_per_s_1080p_fwd_phong_shadows",
        "value": wid * hgt / (us / 1e6),
        "unit": "rays/s",
        "vs_baseline": wid * hgt / (us / 1e6) / TARGET_RAYS_PER_S,
        "value_min": wid * hgt / (us_max / 1e6),
        "value_max": wid * hgt / (us_min / 1e6),
        "sol_fraction": sol["achieved_fraction"],
        "sol_bound": sol["bound"],
        "rows_us": rows,
        **par,
        "device": device,
        "card": gpu,
    }))


if __name__ == "__main__":
    main()
