"""Cameras as affine ray bundles.

The reference generates one ray per pixel with origin (x, y, 0, 1) and a single
shared direction proj*(0,0,1,1) = (0,0,-1,-1) — effectively an orthographic
camera marching down -z in image-space units (states/MainState.cpp:34-50;
SURVEY.md §2 #4). The w=-1 component participates in 4-D dots on both reference
backends but contributes 0 at runtime (L.w == 0), so the 3-D formulation here
is exact.

Device-first design: instead of materializing a (H*W, 4) rayOrigins buffer and
shipping it to the device every launch (MainState.cpp:845-855), a camera is six
vectors — an *affine ray bundle*:

    origin(x, y) = o0 + x * dox + y * doy
    dir(x, y)    = normalize?(d0 + x * ddx + y * ddy)

Kernels regenerate rays in-register from broadcasted_iota pixel coordinates:
zero memory traffic for ray gen, and the same code path covers both the legacy
ortho camera (ddx = ddy = 0, no normalize) and a real pinhole camera.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Affine ray bundle. All fields are (3,) float32 arrays except the static
    `normalize` flag (shared-direction cameras keep the reference's
    unnormalized direction semantics)."""

    o0: jax.Array   # origin at pixel (0, 0)
    dox: jax.Array  # d(origin)/dx
    doy: jax.Array  # d(origin)/dy
    d0: jax.Array   # direction at pixel (0, 0)
    ddx: jax.Array  # d(direction)/dx
    ddy: jax.Array  # d(direction)/dy
    normalize: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @property
    def shared_dir(self) -> bool:
        """True when every pixel shares one direction (legacy ortho mode)."""
        return not self.normalize

    def shift_subpixel(self, dx: float, dy: float) -> "Camera":
        """Camera whose pixel (x, y) sees the original's (x+dx, y+dy): shift
        both affine bundles along their pixel derivatives. Exact for both
        camera families — the MSAA jitter primitive."""
        return dataclasses.replace(
            self,
            o0=self.o0 + dx * self.dox + dy * self.doy,
            d0=self.d0 + dx * self.ddx + dy * self.ddy,
        )

    def rays(self, height: int, width: int) -> Tuple[jax.Array, jax.Array]:
        """Materialize (H, W, 3) origins and directions. Used by the oracle /
        XLA path; Pallas kernels inline the affine form instead."""
        y = jnp.arange(height, dtype=jnp.float32)[:, None, None]
        x = jnp.arange(width, dtype=jnp.float32)[None, :, None]
        o = self.o0 + x * self.dox + y * self.doy
        d = self.d0 + x * self.ddx + y * self.ddy
        o = jnp.broadcast_to(o, (height, width, 3))
        d = jnp.broadcast_to(d, (height, width, 3))
        if self.normalize:
            d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return o, d


def map_row_chunks(fn, camera: Camera, height: int, width: int,
                   row_chunk: int):
    """fn over the camera's rays in sequential blocks of `row_chunk` rows
    -> (height, width, C). The rows are padded up to a whole number of
    chunks (the extra rows are rays past the image edge) and cropped."""
    if height <= row_chunk:
        return fn(camera.rays(height, width))
    n = -(-height // row_chunk)
    o, d = camera.rays(n * row_chunk, width)
    out = jax.lax.map(
        fn,
        (o.reshape(n, row_chunk, width, 3), d.reshape(n, row_chunk, width, 3)),
    )
    return out.reshape(n * row_chunk, width, -1)[:height]


def legacy_ortho_camera() -> Camera:
    """The reference camera: origin (x, y, 0), shared direction (0, 0, -1).

    glm::perspective(45, 4/3, 0, 100) * (0,0,1,1) evaluates to (0,0,-1,-1)
    because zNear=0 collapses the projective terms (MainState.cpp:37-39);
    only the xyz part (0,0,-1) is live in the intersection math.
    """
    z3 = jnp.zeros(3, jnp.float32)
    return Camera(
        o0=z3,
        dox=jnp.array([1.0, 0.0, 0.0], jnp.float32),
        doy=jnp.array([0.0, 1.0, 0.0], jnp.float32),
        d0=jnp.array([0.0, 0.0, -1.0], jnp.float32),
        ddx=z3,
        ddy=z3,
        normalize=False,
    )


def pinhole_camera(
    position,
    look_at,
    up=(0.0, 1.0, 0.0),
    fov_degrees: float = 45.0,
    width: int = 640,
    height: int = 480,
) -> Camera:
    """A real pinhole camera (the generalization BASELINE.json asks for).

    Rays share an origin; directions fan out through an image plane one unit
    in front of the camera. Directions are normalized per pixel so hit
    distances are metric.
    """
    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    fwd = look_at - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)

    aspect = width / height
    half_h = float(np.tan(np.radians(fov_degrees) / 2.0))
    half_w = half_h * aspect

    # Direction at pixel center (x + .5, y + .5); x right, y DOWN the image
    # (the reference scans row-major top-to-bottom, MainState.cpp:44-50).
    ddx = right * (2.0 * half_w / width)
    ddy = -true_up * (2.0 * half_h / height)
    d00 = fwd - right * half_w + true_up * half_h + 0.5 * ddx + 0.5 * ddy

    z3 = jnp.zeros(3, jnp.float32)
    return Camera(
        o0=jnp.asarray(position),
        dox=z3,
        doy=z3,
        d0=jnp.asarray(d00, dtype=jnp.float32),
        ddx=jnp.asarray(ddx, dtype=jnp.float32),
        ddy=jnp.asarray(ddy, dtype=jnp.float32),
        normalize=True,
    )
