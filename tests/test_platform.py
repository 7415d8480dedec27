"""Platform rules: backend choice, interpret mode, compile cache, device
peaks, the kernel wrappers' block layout and stored planes, lowering of the
kernels for the GPU, and the XLA renderers' row-chunk padding."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opencl_ray_tracer import (
    RenderConfig,
    compile_cache_dir,
    create_scene1,
    legacy_ortho_camera,
    pinhole_camera,
    random_scene,
    render,
)
from opencl_ray_tracer.runtime import Backend, check_kernel_platform, default_backend


@pytest.mark.parametrize(
    "platform,expect", [("cpu", Backend.XLA), ("gpu", Backend.PALLAS)]
)
def test_backend_follows_platform(platform, expect):
    assert default_backend(platform) == expect


@pytest.mark.parametrize("platform", ["rocm", "metal", "iree"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no renderer backend"):
        default_backend(platform)


def test_cpu_process_defaults_to_xla():
    assert RenderConfig().backend is None
    assert default_backend() == Backend.XLA


@pytest.mark.parametrize("soft", [False, True])
def test_pallas_without_gpu_or_interpret_raises(soft):
    cfg = RenderConfig(width=128, height=64, shading="lambert", soft=soft,
                       framebuffer_dtype="float")
    with pytest.raises(RuntimeError, match="GPU only"):
        render(create_scene1(), legacy_ortho_camera(), cfg, backend="pallas")
    check_kernel_platform(True)  # asked-for interpret mode is allowed


@pytest.mark.parametrize(
    "env,expect_none",
    [({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, True), ({}, False)],
)
def test_compile_cache_rule(env, expect_none):
    import os

    import opencl_ray_tracer

    got = compile_cache_dir(env)
    if expect_none:
        assert got is None
    else:
        root = os.path.dirname(os.path.dirname(opencl_ray_tracer.__file__))
        assert got == os.path.join(root, ".jax_cache")


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-40GB", "NVIDIA H200", "cpu"])
def test_unknown_device_peaks_raise(kind):
    from opencl_ray_tracer.utils.profiling import device_peaks

    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(kind)


@pytest.mark.parametrize("rows", [2, 4, 8])
def test_block_index_map_covers_tiles(rows):
    """Program (t, s) owns image rows [s*rows, +rows) of tile t: the blocks
    of all programs tile the padded frame exactly once."""
    from opencl_ray_tracer.kernels.fwd_tiled import TILE_H, TILE_W
    from opencl_ray_tracer.kernels.soft_tiled import _block_spec

    nty, ntx = 3, 2
    spec = _block_spec(rows, ntx)
    seen = set()
    for t in range(nty * ntx):
        for s in range(TILE_H // rows):
            bi, bj = spec.index_map(t, s)
            seen.add((int(bi), int(bj)))
            assert int(bi) * rows // TILE_H == t // ntx
            assert int(bj) == t % ntx
    assert len(seen) == nty * (TILE_H // rows) * ntx
    assert spec.block_shape == (rows, TILE_W)


@pytest.mark.parametrize(
    "width,height", [(100, 70), (129, 65), (256, 128)]
)
def test_tiled_frame_padding(width, height):
    """Frames that are not whole tiles render at their own size."""
    cfg = RenderConfig(width=width, height=height, shading="legacy",
                       framebuffer_dtype="packed", interpret=True)
    words = render(create_scene1(), legacy_ortho_camera(), cfg,
                   backend="pallas")
    assert words.shape == (height, width) and words.dtype == jnp.int32


@pytest.mark.parametrize(
    "shading,shadows,expect",
    [("phong", True, 14), ("phong", False, 13), ("lambert", True, 14),
     ("lambert", False, 6), ("legacy", True, 6)],
)
def test_stored_finals_planes(shading, shadows, expect):
    """The forward stores for the backward the streaming finals of its
    layout (aggregate 13 planes, per-primitive shading 6) plus, with
    shadows in an aggregate mode, one log-visibility plane per light."""
    from opencl_ray_tracer.kernels.soft_tiled import _bin_soft, _n_stored, _soft_cfg

    packed = create_scene1().pack()
    bins = _bin_soft(packed, jnp.float32(0.5), legacy_ortho_camera(),
                     height=128, width=256, k=32, shadows=shadows, shadow_k=64)
    assert _n_stored(_soft_cfg(bins, packed, shading, shadows)) == expect


def _lower_for_gpu(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize(
    "shading,shadows,packed_out,camera",
    [("legacy", False, True, "ortho"), ("phong", True, False, "ortho"),
     ("phong", True, True, "pinhole")],
)
def test_forward_kernel_lowers_through_triton(shading, shadows, packed_out,
                                              camera):
    """Every primitive of the forward kernel has a Triton lowering (the
    GPU's own compiler is not reachable here; this is the part that is)."""
    from opencl_ray_tracer.kernels.fwd_tiled import _render_tiled_jit, bin_scene

    scene = create_scene1()
    packed = scene.pack()
    cam = legacy_ortho_camera() if camera == "ortho" else pinhole_camera(
        position=(128.0, 64.0, 300.0), look_at=(128.0, 64.0, -85.0),
        fov_degrees=60.0, width=256, height=128,
    )
    bins = bin_scene(packed, height=128, width=256, shadows=shadows,
                     camera=cam if cam.normalize else None)
    text = _lower_for_gpu(
        lambda p, c, b: _render_tiled_jit(
            p, c, b, height=128, width=256, shading=shading,
            shadows=shadows, out_format="packed" if packed_out else "float",
        ),
        packed, cam, bins,
    ).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize("shading,shadows", [("legacy", False), ("phong", True)])
def test_soft_kernels_lower_through_triton(shading, shadows):
    """The soft forward and the backward's in-kernel jax.vjp lower through
    Triton (grad of the custom_vjp lowers both kernels)."""
    from opencl_ray_tracer.kernels.soft_tiled import render_soft_tiled

    cfg = RenderConfig(width=256, height=128, shading=shading,
                       shadows=shadows, soft=True, framebuffer_dtype="float")
    cam = legacy_ortho_camera()

    # the public entry refuses compiled kernels without a GPU, so lower the
    # custom_vjp core it calls
    from opencl_ray_tracer.kernels import soft_tiled as stl

    def core_loss(packed):
        img = stl._soft_tiled_core(
            packed, cam, jnp.float32(1.0), jnp.float32(0.5), 128, 256,
            shading, shadows, False, 32, 64,
        )
        return jnp.mean(img[..., :3] ** 2)

    text = _lower_for_gpu(jax.grad(core_loss), create_scene1().pack()).as_text()
    assert text.count("__gpu$xla.gpu.triton") >= 2
    with pytest.raises(RuntimeError, match="GPU only"):
        render_soft_tiled(create_scene1(), cam, cfg)


@pytest.mark.parametrize("height", [37, 70])
def test_xla_row_chunks_pad_odd_heights(height):
    """Heights that are not a multiple of the row chunk are padded to whole
    chunks and cropped: the chunked render equals the unchunked one."""
    from opencl_ray_tracer.models.xla_backend import render_xla_jit

    scene = create_scene1()
    cam = legacy_ortho_camera()
    kw = dict(height=height, width=96, shading="phong", shadows=True,
              as_int=False)
    chunked = render_xla_jit(scene, cam, row_chunk=16, **kw)
    whole = render_xla_jit(scene, cam, row_chunk=1024, **kw)
    assert chunked.shape == (height, 96, 4)
    np.testing.assert_array_equal(np.asarray(chunked), np.asarray(whole))


@pytest.mark.parametrize("height", [37, 70])
def test_soft_row_chunks_pad_odd_heights(height):
    from opencl_ray_tracer.diff.soft import render_soft_jit

    scene = create_scene1()
    cam = legacy_ortho_camera()
    kw = dict(height=height, width=96, shading="phong", shadows=True)
    t = (jnp.float32(1.0), jnp.float32(0.5))
    chunked = render_soft_jit(scene, cam, *t, row_chunk=16, **kw)
    whole = render_soft_jit(scene, cam, *t, row_chunk=1024, **kw)
    assert chunked.shape == (height, 96, 4)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(whole),
                               atol=1e-4)


def test_packed_scene_unpack_roundtrip():
    scene = random_scene(7, 3, seed=1)
    back = scene.pack().unpack()
    for a, b in zip(jax.tree_util.tree_leaves(scene),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
