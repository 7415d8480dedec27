"""The compiled Triton kernels on the card, against the plain references.

Marked `gpu`: they skip where JAX has no GPU. Run on the card with

    python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencl_ray_tracer import RenderConfig, legacy_ortho_camera, random_scene, render
from opencl_ray_tracer.diff.soft import render_soft_jit
from opencl_ray_tracer.ref import render_reference

pytestmark = pytest.mark.gpu

W, H = 512, 256


@pytest.mark.parametrize("shading,shadows", [("legacy", False), ("phong", True)])
def test_compiled_forward_matches_oracle(gpu, shading, shadows):
    scene = random_scene(30, 20, seed=3, bounds=(W - 10.0, H - 10.0))
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=W, height=H, shading=shading, shadows=shadows,
                       framebuffer_dtype="packed", cull_k=64)
    from opencl_ray_tracer.ops.shading import pack_framebuffer_words

    words = np.asarray(render(scene, cam, cfg, backend="pallas"))
    oracle = np.asarray(pack_framebuffer_words(render_reference(
        scene, cam, cfg.replace(framebuffer_dtype="float"))))
    assert (words == oracle).mean() > 0.995


def test_compiled_soft_grads_match_twin(gpu):
    scene = random_scene(5, 3, seed=4, bounds=(W - 10.0, H - 10.0))
    cam = legacy_ortho_camera()
    cfg = RenderConfig(width=W, height=H, shading="phong", shadows=True,
                       soft=True, framebuffer_dtype="float",
                       tau_depth=1.0, tau_edge=0.5)

    def loss(fn):
        return jax.grad(lambda s: jnp.mean(fn(s)[..., :3] ** 2))

    gk = loss(lambda s: render(s, cam, cfg, backend="pallas"))(scene)
    with jax.default_matmul_precision("highest"):
        gt = loss(lambda s: render_soft_jit(
            s, cam, jnp.float32(1.0), jnp.float32(0.5), height=H, width=W,
            shading="phong", shadows=True))(scene)
    for a, b in zip(jax.tree_util.tree_leaves(gk), jax.tree_util.tree_leaves(gt)):
        a, b = np.asarray(a), np.asarray(b)
        if a.size:
            assert np.abs(a - b).max() <= 1e-2 * (np.abs(b).max() + 1e-20)
