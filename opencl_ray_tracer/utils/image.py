"""Framebuffer -> image conversion and PNG IO.

The reference converts its int RGBA pixel vector to an SDL surface per-pixel
(states/MainState.cpp:974-1045) and has a lodepng-based PNG dump sketched in
(encodePNG, :410-417). Here:

- `pack_rgba`: int32/float32 (H, W, 4) framebuffer -> contiguous uint8 RGBA,
  clamped to [0, 255] (the display-path behaviour; the raw int framebuffer
  keeps the reference's unclamped values for parity testing). Uses the native
  C++ packer when built.
- `write_png` / `read_png`: PNG encode/decode via the native C++ codec
  (lodepng's role), built from the tracked sources on first use.
"""

from __future__ import annotations

import numpy as np


def unpack_words(words) -> np.ndarray:
    """(H, W) packed int32 RGBA words -> (H, W, 4) uint8.

    The packed framebuffer (RenderConfig.framebuffer_dtype='packed') stores
    R|G<<8|B<<16|A<<24 per pixel — the little-endian RGBA byte stream — so
    unpacking is a byte view, not arithmetic."""
    w = np.ascontiguousarray(np.asarray(words), dtype="<i4")
    return w.view(np.uint8).reshape(w.shape + (4,))


def pack_rgba(framebuffer) -> np.ndarray:
    """(H, W, 4) int32/float32 -> (H, W, 4) uint8, clamped.

    Also accepts a 2-D (H, W) int32 PACKED framebuffer (one RGBA word per
    pixel, the tiled Pallas kernel's fastest output format) — the packed
    words are already the clamped byte stream, so conversion is free."""
    fb = np.asarray(framebuffer)
    if fb.ndim == 2 and fb.dtype == np.int32:
        return unpack_words(fb)
    try:
        from opencl_ray_tracer.native import pack_rgba_native

        if fb.dtype == np.int32:
            return pack_rgba_native(fb)
    except Exception:
        pass
    return np.clip(fb, 0, 255).astype(np.uint8)


def write_png(path: str, framebuffer) -> None:
    """Encode the framebuffer to a PNG file (encodePNG role)."""
    from opencl_ray_tracer.native import encode_png_native

    encode_png_native(path, pack_rgba(framebuffer))


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 4) uint8 (for golden-image tests and
    inverse-rendering targets)."""
    from opencl_ray_tracer.native import decode_png_native

    return decode_png_native(path)
