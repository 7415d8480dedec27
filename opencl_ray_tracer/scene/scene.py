"""Scene model: SoA arrays of spheres + flattened cube triangles + lights.

The reference already stores spheres SoA (states/MainState.h:98-103 —
parallel origin/radius/colour vectors) and flattens cube triangles into one
vertex array for the kernel (MainState.cpp:645-655). That layout is exactly
right for a vectorized tracer, so the Scene pytree keeps it, in two forms:

- `Scene`    — user-facing pytree: sphere_origin (S,3), sphere_radius (S,),
               sphere_colour (S,4), tri_verts (T,3,3), tri_colour (T,4),
               lights. Differentiable leaves.
- `PackedScene` — device layout for kernels: arrays transposed to put the
               primitive axis LAST and
               zero/far-padded to a lane multiple so kernels need no masks:
               zero triangles have det == 0 (Möller–Trumbore miss,
               rayTracer.cl:54-55) and padding spheres sit at z=+1e9 with
               radius 0 (geometric-test miss, rayTracer.cl:86-97).

`pack()` is pure jnp, so gradients flow *through* packing back to the Scene
leaves — the packed form is just a layout change inside the traced program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Lights:
    """Point lights + global material knobs for lambert/phong shading."""

    position: jax.Array       # (L, 3)
    colour: jax.Array         # (L, 3) linear RGB in [0, 1]
    intensity: jax.Array      # (L,)
    ambient: jax.Array        # () scalar ambient term
    spec_strength: jax.Array  # () Phong specular strength
    shininess: jax.Array      # () Phong exponent

    @classmethod
    def default(cls) -> "Lights":
        """One white headlight above-left of the legacy image volume."""
        return cls(
            position=jnp.array([[200.0, 100.0, 200.0]], jnp.float32),
            colour=jnp.array([[1.0, 1.0, 1.0]], jnp.float32),
            intensity=jnp.array([1.0], jnp.float32),
            ambient=jnp.float32(0.1),
            spec_strength=jnp.float32(0.5),
            shininess=jnp.float32(32.0),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    """User-facing scene pytree. All leaves are differentiable float32."""

    sphere_origin: jax.Array  # (S, 3)
    sphere_radius: jax.Array  # (S,)
    sphere_colour: jax.Array  # (S, 4) RGBA; RGB in [0,1], A=255 (ref convention)
    tri_verts: jax.Array      # (T, 3, 3) triangle vertices (12 per cube)
    tri_colour: jax.Array     # (T, 4) per-triangle RGBA
    lights: Lights

    @classmethod
    def build(
        cls,
        sphere_origin=None,
        sphere_radius=None,
        sphere_colour=None,
        cubes=None,
        tri_verts=None,
        tri_colour=None,
        lights: Optional[Lights] = None,
    ) -> "Scene":
        from opencl_ray_tracer.scene.cube import cubes_to_triangles

        def arr(x, shape_tail):
            if x is None:
                return jnp.zeros((0,) + shape_tail, jnp.float32)
            # jnp.array (not np) so traced values can appear in scene builds
            # (e.g. scenes constructed inside jax.grad).
            return jnp.array(x, dtype=jnp.float32)

        if cubes is not None:
            assert tri_verts is None and tri_colour is None
            tv, tc = cubes_to_triangles(cubes)
            tri_verts, tri_colour = jnp.asarray(tv), jnp.asarray(tc)
        else:
            tri_verts = arr(tri_verts, (3, 3))
            tri_colour = arr(tri_colour, (4,))

        return cls(
            sphere_origin=arr(sphere_origin, (3,)),
            sphere_radius=arr(sphere_radius, ()),
            sphere_colour=arr(sphere_colour, (4,)),
            tri_verts=tri_verts,
            tri_colour=tri_colour,
            lights=lights or Lights.default(),
        )

    @property
    def num_spheres(self) -> int:
        return self.sphere_origin.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def num_cubes(self) -> int:
        return self.num_triangles // 12

    def pack(self, lane: int = 128) -> "PackedScene":
        """Transpose + pad to device layout. Pure jnp (differentiable)."""
        s = self.num_spheres
        t = self.num_triangles
        sp = max(_round_up(max(s, 1), lane), lane)
        tp = max(_round_up(max(t, 1), lane), lane)

        # Spheres: pad with far-away zero-radius spheres that can never win
        # (distSq > 0 => miss; and t=1e9 > the 300000 sentinel regardless).
        so = jnp.full((sp, 3), jnp.array([0.0, 0.0, 1e9]), jnp.float32)
        so = so.at[:s].set(self.sphere_origin) if s else so
        sr = jnp.zeros((sp,), jnp.float32)
        sr = sr.at[:s].set(self.sphere_radius) if s else sr
        sc = jnp.zeros((sp, 4), jnp.float32)
        sc = sc.at[:s].set(self.sphere_colour) if s else sc

        # Triangles: zero-pad => degenerate (det == 0) => guaranteed miss.
        tv = jnp.zeros((tp, 3, 3), jnp.float32)
        tv = tv.at[:t].set(self.tri_verts) if t else tv
        tc = jnp.zeros((tp, 4), jnp.float32)
        tc = tc.at[:t].set(self.tri_colour) if t else tc

        v0 = tv[:, 0, :]
        e1 = tv[:, 1, :] - v0
        e2 = tv[:, 2, :] - v0

        return PackedScene(
            sph_origin=so.T,            # (3, Sp)
            sph_radius=sr[None, :],     # (1, Sp)
            sph_colour=sc.T,            # (4, Sp)
            tri_v0=v0.T,                # (3, Tp)
            tri_e1=e1.T,                # (3, Tp)
            tri_e2=e2.T,                # (3, Tp)
            tri_colour=tc.T,            # (4, Tp)
            lights=self.lights,
            n_spheres=s,
            n_tris=t,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PackedScene:
    """Kernel-facing layout: primitive axis last, padded to a multiple of
    128 so padded slots are geometric misses and no mask is needed.

    Footprint at the 1200-triangle stress scene:
    ~(3+3+3+4)*1280*4B tris + (3+1+4)*128*4B spheres ≈ 70 KB — the
    analogue of the reference's read-only __global scene buffers
    (MainState.cpp:678-743).
    """

    sph_origin: jax.Array  # (3, Sp)
    sph_radius: jax.Array  # (1, Sp)
    sph_colour: jax.Array  # (4, Sp)
    tri_v0: jax.Array      # (3, Tp)
    tri_e1: jax.Array      # (3, Tp)
    tri_e2: jax.Array      # (3, Tp)
    tri_colour: jax.Array  # (4, Tp)
    lights: Lights
    n_spheres: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_tris: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def padded_spheres(self) -> int:
        return self.sph_origin.shape[1]

    @property
    def padded_tris(self) -> int:
        return self.tri_v0.shape[1]

    def unpack(self) -> Scene:
        """The real (unpadded) primitives back as a Scene — the input the
        XLA renderers take. Pure jnp, so gradients flow back to the packed
        leaves."""
        s, t = self.n_spheres, self.n_tris
        v0 = self.tri_v0.T[:t]
        return Scene(
            sphere_origin=self.sph_origin.T[:s],
            sphere_radius=self.sph_radius[0, :s],
            sphere_colour=self.sph_colour.T[:s],
            tri_verts=jnp.stack(
                [v0, v0 + self.tri_e1.T[:t], v0 + self.tri_e2.T[:t]], axis=1
            ),
            tri_colour=self.tri_colour.T[:t],
            lights=self.lights,
        )
