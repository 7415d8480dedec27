"""Per-frame time of a render or train step, in microseconds.

N frames run inside ONE jitted lax.scan, each frame with a DIFFERENT camera
origin (defeats CSE; identical compute), each frame consumed into a scalar
carry (defeats DCE): one dispatch and one fence per timed run, so the fixed
cost of launching a program is spread over N frames. The host clock around
block_until_ready gives the time; the median of a few runs is reported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp


def _scan_frame_us(render_fn, camera, n_frames: int, reps: int,
                   scalar_body: bool) -> float:
    """Median over `reps` of the wall time of ONE jitted n_frames-scan
    dispatch, divided by n_frames (one compile per call)."""

    @jax.jit
    def run(cam0):
        jit_eps = jnp.linspace(0.0, 0.125, n_frames)

        def body(acc, e):
            cam = dataclasses.replace(cam0, o0=cam0.o0 + e * 1e-3)
            if scalar_body:
                return acc + render_fn(cam).astype(jnp.float32), ()
            fb = render_fn(cam)
            if fb.ndim == 2:  # packed int32 words
                probe = (fb[5, 5] & 0xFF).astype(jnp.float32) + (
                    fb[-1, -1] & 0xFF
                ).astype(jnp.float32)
            else:
                probe = fb[5, 5, 0].astype(jnp.float32) + fb[
                    -1, -1, 1
                ].astype(jnp.float32)
            return acc + probe, ()

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), jit_eps)
        return acc

    jax.block_until_ready(run(camera))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        jax.block_until_ready(run(camera))
        samples.append((time.perf_counter_ns() - t0) / 1e3 / n_frames)
    samples.sort()
    return samples[len(samples) // 2]


def median_spread(samples) -> tuple:
    """(median, min, max) of an iterable of measurements — the one
    aggregation policy for repeated slope samples (min/max carry the
    spread into records)."""
    s = sorted(samples)
    return s[len(s) // 2], s[0], s[-1]


def device_frame_time_us(
    render_fn: Callable,
    camera,
    n_frames: int = 100,
    reps: int = 5,
) -> float:
    """Per-frame time in microseconds (see module docstring).
    render_fn(camera) -> framebuffer array; camera is a Camera pytree whose
    o0 is perturbed per frame by a sub-pixel jitter (identical compute)."""
    return _scan_frame_us(render_fn, camera, n_frames, reps,
                          scalar_body=False)


def device_step_time_us(
    step_fn: Callable,
    camera,
    n_frames: int = 30,
    reps: int = 5,
) -> float:
    """Per-step time in microseconds for SCALAR-returning steps (e.g. a
    loss whose grad was already consumed into it) — the shape for timing
    fwd+bwd passes. Same structure as device_frame_time_us."""
    return _scan_frame_us(step_fn, camera, n_frames, reps, scalar_body=True)
