#!/usr/bin/env python
"""Smoke test of the ray tracer on one GPU, through its user entry points.

  python chip_smoke.py          # one card: every phase below
  python chip_smoke.py --four   # four cards: only the sharded phases

Phases (one card), each checked against the repo's plain references:

  1. device      JAX's device is a GPU; its kind, count and the card's
                 name and power limit are printed.
  2. fwd 1080p   models.renderer.render through the tiled Triton kernel:
                 the headline scene (10 spheres + 1 cube, Phong + hard
                 shadows, packed words) with the ortho and the pinhole
                 camera, and the reference's 200-primitive stress scene
                 (legacy shading, cull_k=96), each against the CPU oracle
                 (ref/tracer.py); then one frame forced to overflow its
                 candidate lists, so the XLA fallback runs on the card.
  3. fwd 4K      the stress scene at 3840x2160, against the XLA renderer on
                 the card; the compiled program's memory analysis is
                 printed.
  4. soft 1080p  soft fwd+bwd (Phong + soft shadows) of the headline scene,
                 image and every gradient leaf against the dense jnp twin
                 (diff/soft.render_soft_jit) at highest matmul precision.
  5. soft stress the same on one 64-row band of the stress scene
                 (parallel.mesh.shift_camera_rows), where the dense twin
                 fits, leaving out the pixels where the twin gives the
                 primitives the kernel culled more than 1% of its softmin
                 weight (see Tolerances).
  6. train       three parallel.make_train_step steps on a one-card mesh
                 at 1080p: the loss is finite and decreases.

With --four: make_train_step on a flat four-card mesh at 1080p (270 rows
per card) and render_sharded of the 4K stress scene, each against the same
computation on one card in this process.

Tolerances. Hard frames: the fraction of identical pixels must exceed
0.995 (the CPU suite's threshold): the kernel's affine intersection
coefficients and the oracle's per-pixel Möller–Trumbore round differently,
which moves a few pixels on silhouettes and integer boundaries. Soft
images: 99.9% of channel values within 0.15 of the twin (the CPU suite's
bound on its 256x128 frames), and every value within 4.0 of 255 — the
card's exp, rsqrt and sigmoid differ from XLA's in the last bits, and the
steep soft silhouettes of a few edge pixels amplify that. Soft gradients:
every leaf within 1e-2 of its largest magnitude (sums over up to two
million pixels, accumulated in another order by the kernel).

Stress band: the kernel culls candidates whose bbox lies 16 sigma of
coverage away from the tile, but the twin ranks by depth plus log
coverage, so a culled sliver 26 sigma out and a few units nearer can still
win the twin's softmin at a pixel (up to 15.3 of 255 at rows 512..576, on
the CPU interpreter too — a property of the culling, not of the card).
Those pixels are computed from the twin itself: the share of its softmin
weight that falls on primitives outside the pixel's tile candidates. Where
that share exceeds 1% (the culling alone could then move the pixel by 2.55
of 255) the pixel is left out of the image bound and of the loss whose
gradients are compared; they must be fewer than 0.1% of the band, and
every other pixel is held to the bounds above.

Any failed check exits non-zero before the last line. The last line of
stdout is {"ok": true, "device": {...}} with the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from opencl_ray_tracer import (
    RenderConfig,
    legacy_ortho_camera,
    pinhole_camera,
    random_scene,
    render,
)
from opencl_ray_tracer.diff.soft import (
    _sphere_soft_planar,
    _tri_soft_planar,
    render_soft_jit,
)
from opencl_ray_tracer.kernels.fwd_tiled import (
    TILE_H,
    TILE_W,
    bin_scene,
    render_tiled_packed,
)
from opencl_ray_tracer.kernels.soft_tiled import _bin_soft
from opencl_ray_tracer.models.xla_backend import render_xla_jit
from opencl_ray_tracer.ops.shading import pack_framebuffer_words
from opencl_ray_tracer.parallel import (
    init_train_state,
    make_mesh,
    make_train_step,
    replicate,
    shard_rows,
)
from opencl_ray_tracer.parallel.mesh import render_sharded, shift_camera_rows
from opencl_ray_tracer.ref import render_reference

W, H = 1920, 1080
W4, H4 = 3840, 2160
T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    log(f"ok: {what}")


def frac_identical(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 3:
        return float(np.all(a == b, axis=-1).mean())
    return float((a == b).mean())


def scenes():
    bounds = (W - 10.0, H - 10.0)
    return (random_scene(10, 1, seed=0, bounds=bounds),
            random_scene(100, 100, seed=0, bounds=bounds))


def headline_pinhole():
    return pinhole_camera(position=(W / 2.0, H / 2.0, 900.0),
                          look_at=(W / 2.0, H / 2.0, -85.0),
                          fov_degrees=60.0, width=W, height=H)


def phase_device(expect: int) -> dict:
    devs = jax.devices()
    d = devs[0]
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    check(d.platform == "gpu", "JAX's device is a GPU")
    check(len(devs) >= expect, f"at least {expect} device(s) visible")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def phase_forward(hl, st) -> None:
    cam = legacy_ortho_camera()
    cfg_hl = RenderConfig(width=W, height=H, shading="phong", shadows=True,
                          framebuffer_dtype="packed")
    for name, c in (("ortho", cam), ("pinhole", headline_pinhole())):
        words = render(hl, c, cfg_hl)
        oracle = pack_framebuffer_words(render_reference(
            hl, c, cfg_hl.replace(framebuffer_dtype="float")))
        f = frac_identical(words, oracle)
        check(f > 0.995, f"fwd 1080p headline {name} phong+shadows packed: "
                         f"{f:.6f} of pixels identical to the CPU oracle")
    cfg_st = RenderConfig(width=W, height=H, shading="legacy", cull_k=96)
    oracle_st = render_reference(st, cam, cfg_st)
    f = frac_identical(render(st, cam, cfg_st), oracle_st)
    check(f > 0.995, f"fwd 1080p stress legacy k=96: {f:.6f} identical")
    # candidate lists capped at 8: every busy tile overflows and the frame
    # takes the XLA fallback inside the jitted tiled renderer
    packed = st.pack()
    bins = bin_scene(packed, height=H, width=W, k=8)
    check(bool(bins.overflow), "cull_k=8 overflows the stress scene")
    f = frac_identical(render_tiled_packed(packed, cam, cfg_st, bins=bins),
                       oracle_st)
    check(f > 0.995, f"fwd 1080p overflow frame (XLA fallback on the card): "
                     f"{f:.6f} identical")


def phase_4k() -> None:
    cam = legacy_ortho_camera()
    s4 = random_scene(100, 100, seed=2, bounds=(W4 - 10.0, H4 - 10.0))
    cfg = RenderConfig(width=W4, height=H4, shading="legacy", cull_k=96,
                       framebuffer_dtype="packed")
    fn = jax.jit(lambda s: render(s, cam, cfg))
    log(f"4K memory analysis: {fn.lower(s4).compile().memory_analysis()}")
    words = fn(s4)
    ref = pack_framebuffer_words(render_xla_jit(
        s4, cam, height=H4, width=W4, shading="legacy", row_chunk=8,
        as_int=False))
    check(words.shape == (H4, W4), "4K frame shape")
    f = frac_identical(words, ref)
    check(f > 0.995, f"fwd 4K stress legacy k=96: {f:.6f} identical to the "
                     f"XLA renderer on the card")


def soft_pair(scene, cam, cfg, keep=None):
    """(image, grads) of the kernel pair and of the dense twin; the loss
    sums the pixels where `keep` (H, W) is true, all by default."""
    w = jnp.ones((cfg.height, cfg.width, 1)) if keep is None else (
        jnp.asarray(keep, jnp.float32)[..., None])

    def loss(fn):
        return lambda s: jnp.mean((fn(s)[..., :3] * w) ** 2)

    kern = lambda s: render(s, cam, cfg)
    twin = lambda s: render_soft_jit(
        s, cam, jnp.float32(cfg.tau_depth), jnp.float32(cfg.tau_edge),
        height=cfg.height, width=cfg.width, shading=cfg.shading,
        shadows=cfg.shadows,
    )
    out_k = (jax.jit(kern)(scene), jax.jit(jax.grad(loss(kern)))(scene))
    with jax.default_matmul_precision("highest"):
        out_t = (jax.jit(twin)(scene), jax.jit(jax.grad(loss(twin)))(scene))
    return out_k, out_t


def culled_share(scene, cam, cfg, rows=16):
    """(H, W): the share of the dense twin's softmin weight that falls on
    primitives the soft kernel culled from the pixel's tile — the twin's
    ranking (diff/soft._soft_aggregate_planar) against the kernel's bins."""
    packed = scene.pack()
    bins = _bin_soft(packed, jnp.float32(cfg.tau_edge), cam,
                     height=cfg.height, width=cfg.width, k=cfg.cull_k,
                     shadows=cfg.shadows, shadow_k=cfg.shadow_cull_k)
    n_tiles = bins.nty * bins.ntx
    tiles = jnp.arange(n_tiles)[:, None]

    def members(idx, valid, n):  # (n_tiles, n): prim is a tile candidate
        col = jnp.where(valid, idx, n)
        return jnp.zeros((n_tiles, n + 1), bool).at[tiles, col].set(True)[:, :n]

    # the twin's primitive order: triangles, then spheres
    member = jnp.concatenate(
        [members(bins.t_idx, bins.t_valid, packed.n_tris),
         members(bins.s_idx, bins.s_valid, packed.n_spheres)], axis=1)
    tau_d, tau_e = jnp.float32(cfg.tau_depth), jnp.float32(cfg.tau_edge)

    @jax.jit
    def share(o, d, y, x):
        oc = tuple(o[..., q].reshape(-1, 1) for q in range(3))
        dc = tuple(d[..., q].reshape(-1, 1) for q in range(3))
        tt, ct, _ = _tri_soft_planar(oc, dc, scene, tau_e)
        ts, cs, _ = _sphere_soft_planar(oc, dc, scene, tau_e)
        t, cov = jnp.concatenate([tt, ts], -1), jnp.concatenate([ct, cs], -1)
        valid = cov > 1e-12
        logit = jnp.where(valid, -t / tau_d + jnp.log(jnp.clip(cov, 1e-12, 1.0)),
                          -1e30)
        w = jax.nn.softmax(logit, axis=-1)
        tile = ((y // TILE_H) * bins.ntx + x // TILE_W).reshape(-1)
        out = jnp.sum(jnp.where(member[tile], 0.0, w), -1)
        return jnp.where(valid.any(-1), out, 0.0).reshape(y.shape)

    o, d = cam.rays(cfg.height, cfg.width)
    yy, xx = jnp.meshgrid(jnp.arange(cfg.height), jnp.arange(cfg.width),
                          indexing="ij")
    return np.concatenate([
        np.asarray(share(o[r:r + rows], d[r:r + rows], yy[r:r + rows],
                         xx[r:r + rows]))
        for r in range(0, cfg.height, rows)
    ])


def compare_soft(name, out_k, out_t, *, max_err, grad_rel, keep=None) -> None:
    """Image and gradients of the kernel pair vs the dense twin, the image
    on the pixels where `keep` (H, W) is true, all by default."""
    (img_k, g_k), (img_t, g_t) = out_k, out_t
    err = np.abs(np.asarray(img_k) - np.asarray(img_t))
    check(bool(np.isfinite(err).all()), f"{name}: finite image")
    if keep is not None:
        err = err[keep]
    p999 = float(np.percentile(err, 99.9))
    off = float((err > 0.15).mean())
    emax = float(err.max())
    check(p999 < 0.15 and emax < max_err,
          f"{name}: image vs dense twin p99.9 {p999:.4f} < 0.15, max "
          f"{emax:.4f} < {max_err} (share of values above 0.15: {off:.2e})")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_k),
                            jax.tree_util.tree_leaves(g_t)):
        a, b = np.asarray(a), np.asarray(b)
        if not a.size:
            continue
        rel = float(np.abs(a - b).max() / (np.abs(b).max() + 1e-20))
        check(bool(np.isfinite(a).all()) and rel < grad_rel,
              f"{name}: grad {jax.tree_util.keystr(path)} rel err "
              f"{rel:.2e} < {grad_rel}")


def soft_config(**kw):
    return RenderConfig(width=W, height=H, shading="phong", shadows=True,
                        soft=True, framebuffer_dtype="float", tau_depth=1.0,
                        tau_edge=0.5, **kw)


def phase_soft(hl, st) -> None:
    cam = legacy_ortho_camera()
    compare_soft("soft fwd+bwd 1080p headline",
                 *soft_pair(hl, cam, soft_config()), max_err=4.0, grad_rel=1e-2)
    band = 64
    name = f"soft fwd+bwd stress rows 512..{512 + band}"
    cam_band = shift_camera_rows(cam, 512)
    cfg = soft_config(cull_k=96, shadow_cull_k=136).replace(height=band)
    culled = culled_share(st, cam_band, cfg)
    keep = culled <= 1e-2
    n_out = int((~keep).sum())
    log(f"{name}: {n_out} of {keep.size} pixels give culled primitives more "
        f"than 1% of the twin's softmin weight (largest share "
        f"{float(culled.max()):.4f})")
    check(n_out < 1e-3 * keep.size, f"{name}: culled-weight pixels < 0.1%")
    compare_soft(name, *soft_pair(st, cam_band, cfg, keep), keep=keep,
                 max_err=4.0, grad_rel=1e-2)


def perturbed(scene):
    """The scene with every sphere moved 3 px: the train steps' start."""
    return dataclasses.replace(
        scene, sphere_origin=scene.sphere_origin + jnp.array([3.0, -3.0, 0.0])
    )


def train_losses(scene, mesh, n_steps=3):
    cfg = soft_config()
    target = render(scene, legacy_ortho_camera(), cfg)
    optimizer = __import__("optax").adam(0.5)
    step = make_train_step(
        legacy_ortho_camera(), cfg, optimizer, mesh=mesh,
        param_filter=lambda path: "sphere_origin" in jax.tree_util.keystr(path),
    )
    state = init_train_state(replicate(perturbed(scene), mesh), optimizer)
    target = shard_rows(target, mesh)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, target)
        losses.append(float(loss))
    return losses, state


def phase_train(hl) -> None:
    losses, _ = train_losses(hl, make_mesh(1))
    check(all(np.isfinite(losses)), f"train losses finite: {losses}")
    check(losses[0] > losses[1] > losses[2], f"train loss decreases: {losses}")


def phase_four(hl) -> None:
    devs = jax.devices()
    one = jax.sharding.Mesh(np.array(devs[:1]), ("image",))
    four = make_mesh(4)
    l1, s1 = train_losses(hl, one)
    l4, s4 = train_losses(hl, four)
    log(f"train losses one card {l1} four cards {l4}")
    check(all(np.isfinite(l4)) and l4[0] > l4[1] > l4[2],
          f"four-card train loss decreases: {l4}")
    # rtol 2e-4: the per-shard partial means are summed in another order
    check(np.allclose(l1, l4, rtol=2e-4, atol=0.0),
          "four-card losses match one card (rtol 2e-4, atol 0)")
    d = float(np.abs(np.asarray(s4.scene.sphere_origin)
                     - np.asarray(s1.scene.sphere_origin)).max())
    check(d < 1e-3, f"four-card trained sphere origins match one card "
                    f"(max diff {d:.2e} px)")
    cam = legacy_ortho_camera()
    s4k = random_scene(100, 100, seed=2, bounds=(W4 - 10.0, H4 - 10.0))
    cfg = RenderConfig(width=W4, height=H4, shading="legacy", cull_k=96,
                       framebuffer_dtype="packed")
    f = frac_identical(render_sharded(s4k, cam, cfg, mesh=four),
                       render_sharded(s4k, cam, cfg, mesh=one))
    check(f > 0.995, f"render_sharded 4K stress on four cards vs one: "
                     f"{f:.6f} identical")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phases, on four cards")
    args = ap.parse_args()
    device = phase_device(4 if args.four else 1)
    hl, st = scenes()
    if args.four:
        phase_four(hl)
    else:
        phase_forward(hl, st)
        phase_4k()
        phase_soft(hl, st)
        phase_train(hl)
    log("all phases passed")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
