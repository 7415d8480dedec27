"""Profiling / tracing — the equivalent of PerformanceCounter+logging
(SURVEY.md §5): jax.profiler traces, annotated ranges, and a speed-of-light
calculator for the ray-trace kernels."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax

from opencl_ray_tracer.utils.log import log_info

# Published peaks per device kind (as jax reports device_kind). The
# kernels' op models count FP32 lane instructions (an FMA is one), so the
# ALU ceiling is the FP32 FLOP/s outside the tensor cores over two.
# Source: NVIDIA H100 data sheet, SXM part — 67 TFLOP/s FP32, 3.35 TB/s HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_lane_ops_per_s": 67e12 / 2,
        "dram_bytes_per_s": 3.35e12,
    },
}


def device_peaks(kind: Optional[str] = None) -> dict:
    """The PEAKS row of `kind` (default: the first device's kind). A device
    without published peaks is an error, not a default."""
    kind = kind if kind is not None else device_kind()
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


@contextlib.contextmanager
def trace(dump_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace around a region (view with xprof/TB)."""
    jax.profiler.start_trace(dump_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log_info("profiler trace written to %s", dump_dir)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in profiler timelines (TraceAnnotation role)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def sol_fraction(
    frame_us: float,
    n_pixels: int,
    n_prim_slots: int,
    ops_per_pair: float = 14.0,
    bytes_per_pixel: float = 36.0,
    shading_ops_per_pixel: float = 0.0,
    shaded_fraction: float = 1.0,
    peaks: Optional[dict] = None,
) -> dict:
    """Speed-of-light fraction for a brute/tiled trace kernel.

    Model: ALU ops = pixels * (prim_slots * ops_per_pair +
    shaded_fraction * shading_ops_per_pixel); DRAM = framebuffer writes
    (ray gen is in-register, the tables are cache-resident). `n_prim_slots` is
    the mean EXECUTED candidate slots per pixel (after culling/ragged
    skipping); `shading_ops_per_pixel` is the per-pixel post-hit cost
    (normal + lighting + pack) charged only on the `shaded_fraction` of
    pixels whose tiles run the shading phase (empty tiles skip it).
    Returns the binding resource and achieved fraction of its ceiling.
    """
    ops = n_pixels * (
        n_prim_slots * ops_per_pair
        + shaded_fraction * shading_ops_per_pixel
    )
    return _sol_result(frame_us, ops, n_pixels * bytes_per_pixel, peaks)


def sol_fraction_ops(
    frame_us: float,
    n_pixels: int,
    intersection_ops_per_pixel: float,
    shading_ops_per_pixel: float = 0.0,
    shaded_fraction: float = 1.0,
    bytes_per_pixel: float = 4.0,
    peaks: Optional[dict] = None,
) -> dict:
    """sol_fraction with the intersection work given directly as ops/pixel —
    for callers that weight slot TYPES by their true per-slot cost (a
    shadow-frustum slot necessarily spends ~2x a primary affine slot)."""
    ops = n_pixels * (
        intersection_ops_per_pixel
        + shaded_fraction * shading_ops_per_pixel
    )
    return _sol_result(frame_us, ops, n_pixels * bytes_per_pixel, peaks)


def _sol_result(us: float, ops: float, dram_bytes: float,
                peaks: Optional[dict]) -> dict:
    peaks = peaks if peaks is not None else device_peaks()
    alu_t = ops / peaks["fp32_lane_ops_per_s"]
    dram_t = dram_bytes / peaks["dram_bytes_per_s"]
    ideal = max(alu_t, dram_t)
    t = us / 1e6
    return {
        "bound": "alu" if alu_t >= dram_t else "dram",
        "ideal_us": ideal * 1e6,
        "achieved_fraction": ideal / t if t > 0 else 0.0,
        "alu_us": alu_t * 1e6,
        "dram_us": dram_t * 1e6,
    }


def device_kind() -> Optional[str]:
    d = jax.devices()[0]
    return getattr(d, "device_kind", None)
