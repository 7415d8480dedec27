"""ctypes bindings for the C++ runtime library (octrt_native).

Builds lazily via `make` (g++ + zlib) on first use if the shared object is
missing. The PNG codec has no other implementation; the framebuffer packer
and the timer fall back to numpy / time.perf_counter_ns.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "liboctrt_native.so")

_lib = None


def _build() -> None:
    subprocess.run(
        ["make", "-s", "-C", _DIR],
        check=True,
        capture_output=True,
    )


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.octrt_now_ns.restype = ctypes.c_int64
    lib.octrt_fb_pack_rgba.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.octrt_fb_pack_rgba_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.octrt_png_encode.restype = ctypes.c_int
    lib.octrt_png_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.octrt_png_decode.restype = ctypes.c_int
    lib.octrt_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    _lib = lib
    return lib


def now_ns() -> int:
    return int(get_lib().octrt_now_ns())


def pack_rgba_native(fb: np.ndarray) -> np.ndarray:
    """(H, W, 4) int32 or float32 -> uint8, clamped, via the C++ packer."""
    fb = np.ascontiguousarray(fb)
    out = np.empty(fb.shape, np.uint8)
    n = fb.size
    lib = get_lib()
    if fb.dtype == np.int32:
        lib.octrt_fb_pack_rgba(fb.ctypes.data, out.ctypes.data, n)
    elif fb.dtype == np.float32:
        lib.octrt_fb_pack_rgba_f32(fb.ctypes.data, out.ctypes.data, n)
    else:
        raise TypeError(f"unsupported framebuffer dtype {fb.dtype}")
    return out


def encode_png_native(path: str, rgba: np.ndarray) -> None:
    rgba = np.ascontiguousarray(rgba)
    assert rgba.dtype == np.uint8 and rgba.ndim == 3 and rgba.shape[2] == 4
    h, w = rgba.shape[:2]
    rc = get_lib().octrt_png_encode(path.encode(), rgba.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"octrt_png_encode failed with code {rc}")


def decode_png_native(path: str) -> np.ndarray:
    lib = get_lib()
    w = ctypes.c_uint32(0)
    h = ctypes.c_uint32(0)
    rc = lib.octrt_png_decode(path.encode(), None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"octrt_png_decode (size query) failed with code {rc}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.octrt_png_decode(
        path.encode(), out.ctypes.data, ctypes.byref(w), ctypes.byref(h)
    )
    if rc != 0:
        raise IOError(f"octrt_png_decode failed with code {rc}")
    return out
