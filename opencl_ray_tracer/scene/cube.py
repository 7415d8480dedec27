"""Cube primitive with baked transforms.

Reproduces the reference's Cube exactly (RayTrace/Cube.cpp:9-83): a unit cube
as 36 vertices (12 triangles), where scale/rotate/translate calls multiply the
current vertex list in place — so the *call sequence* matters and transforms
compose in application order, exactly as in the scene builders
(e.g. states/MainState.cpp:436-439: scale, rotate, rotate, translate).

Rotation composes Z*Y*X per call (Cube.cpp:53-63: glm::rotate post-multiplies,
rotationMat = Rz * Ry * Rx, applied as v' = rotationMat * v).

This class is the host-side *builder*; the differentiable path parameterizes
cubes as (center, scale, euler) and bakes with `bake_cube_params` (pure jnp,
grads flow through).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp

# The 36 unit-cube vertices in the reference's exact order (Cube.cpp:10-45).
UNIT_CUBE_VERTS = np.array(
    [
        [-1, -1, -1], [-1, -1,  1], [-1,  1,  1],
        [ 1,  1, -1], [-1, -1, -1], [-1,  1, -1],
        [ 1, -1,  1], [-1, -1, -1], [ 1, -1, -1],
        [ 1,  1, -1], [ 1, -1, -1], [-1, -1, -1],
        [-1, -1, -1], [-1,  1,  1], [-1,  1, -1],
        [ 1, -1,  1], [-1, -1,  1], [-1, -1, -1],
        [-1,  1,  1], [-1, -1,  1], [ 1, -1,  1],
        [ 1,  1,  1], [ 1, -1, -1], [ 1,  1, -1],
        [ 1, -1, -1], [ 1,  1,  1], [ 1, -1,  1],
        [ 1,  1,  1], [ 1,  1, -1], [-1,  1, -1],
        [ 1,  1,  1], [-1,  1, -1], [-1,  1,  1],
        [ 1,  1,  1], [-1,  1,  1], [ 1, -1,  1],
    ],
    dtype=np.float32,
)

TRIS_PER_CUBE = 12
VERTS_PER_CUBE = 36


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


class Cube:
    """36-vertex cube with in-place baked transforms (reference semantics)."""

    def __init__(self, colour: Sequence[float]):
        self.vertices = UNIT_CUBE_VERTS.copy()  # (36, 3) float32
        colour = np.asarray(colour, np.float32)
        if colour.shape == (3,):
            colour = np.concatenate([colour, [255.0]]).astype(np.float32)
        assert colour.shape == (4,), "cube colour must be RGBA"
        self.colour = colour

    # -- baked transforms (Cube.cpp:53-83) ---------------------------------
    def rotate(self, rotation: Sequence[float]) -> "Cube":
        """rotation = (rx, ry, rz) in radians; applies Rz @ Ry @ Rx."""
        rx, ry, rz = (float(v) for v in rotation)
        m = _rot_z(rz) @ _rot_y(ry) @ _rot_x(rx)
        self.vertices = self.vertices @ m.T
        return self

    def scale(self, s) -> "Cube":
        s = np.broadcast_to(np.asarray(s, np.float32), (3,))
        self.vertices = self.vertices * s
        return self

    def translate(self, t: Sequence[float]) -> "Cube":
        self.vertices = self.vertices + np.asarray(t, np.float32)
        return self

    # -- accessors ----------------------------------------------------------
    def get_triangles(self) -> np.ndarray:
        """(12, 3, 3) triangle vertices (Cube.cpp:48-51 returns the flat 36)."""
        return self.vertices.reshape(TRIS_PER_CUBE, 3, 3)

    def get_colour(self) -> np.ndarray:
        return self.colour


def bake_cube_params(center, scale, euler):
    """Differentiable cube bake: unit verts -> scale -> rotate(Z*Y*X) -> translate.

    Args are jnp arrays — center (3,), scale (3,) or scalar, euler (3,) radians.
    Returns (12, 3, 3) triangle vertices with gradients w.r.t. all inputs.
    (The legacy builders may chain several rotates; this is the single-rotate
    canonical parameterization used by the differentiable path.)
    """
    center = jnp.asarray(center, jnp.float32)
    scale = jnp.broadcast_to(jnp.asarray(scale, jnp.float32), (3,))
    rx, ry, rz = euler[0], euler[1], euler[2]

    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)
    one = jnp.ones(())
    zero = jnp.zeros(())
    mx = jnp.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    my = jnp.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    mz = jnp.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    m = jnp.matmul(
        jnp.matmul(mz, my, precision="highest"), mx, precision="highest"
    )

    verts = jnp.asarray(UNIT_CUBE_VERTS) * scale
    # Geometry must be exact f32: the platform default may lower f32
    # matmuls to TF32 or bf16 passes, which is fine for shading but not for vertices.
    verts = jnp.matmul(verts, m.T, precision="highest") + center
    return verts.reshape(TRIS_PER_CUBE, 3, 3)


def cubes_to_triangles(cubes: Sequence[Cube]) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a cube list to (T, 3, 3) vertices + (T, 4) per-triangle colours,
    the layout the kernels consume (reference flattens the same way,
    MainState.cpp:645-655)."""
    if not cubes:
        return (
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 4), np.float32),
        )
    tris = np.concatenate([c.get_triangles() for c in cubes], axis=0)
    cols = np.concatenate(
        [np.repeat(c.colour[None, :], TRIS_PER_CUBE, axis=0) for c in cubes], axis=0
    )
    return tris.astype(np.float32), cols.astype(np.float32)
