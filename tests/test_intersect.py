"""Unit tests for the intersection ops, including the reference's quirk
semantics (SURVEY.md §7 hard parts: miss-as-0.0, negative-t wins, strict
tie-breaks, cube-before-sphere ordering)."""

import numpy as np
import jax.numpy as jnp

from opencl_ray_tracer.ops import (
    MISS_T,
    intersect_spheres,
    intersect_tris,
    nearest_hit,
)
from opencl_ray_tracer.scene import Scene


def make_scene(**kw):
    return Scene.build(**kw)


class TestSphere:
    def test_direct_hit(self):
        o = jnp.array([0.0, 0.0, 0.0])
        d = jnp.array([0.0, 0.0, -1.0])
        t = intersect_spheres(o, d, jnp.array([[0.0, 0.0, -10.0]]), jnp.array([2.0]))
        np.testing.assert_allclose(np.asarray(t), [8.0], atol=1e-5)

    def test_miss_returns_zero(self):
        """Reference returns 0.0 for miss, not -1 (rayTracer.cl:86-97)."""
        o = jnp.array([100.0, 0.0, 0.0])
        d = jnp.array([0.0, 0.0, -1.0])
        t = intersect_spheres(o, d, jnp.array([[0.0, 0.0, -10.0]]), jnp.array([2.0]))
        assert float(t[0]) == 0.0

    def test_behind_origin_misses(self):
        """tca < 0 => miss even though the line intersects."""
        o = jnp.array([0.0, 0.0, -100.0])
        d = jnp.array([0.0, 0.0, -1.0])
        t = intersect_spheres(o, d, jnp.array([[0.0, 0.0, -10.0]]), jnp.array([2.0]))
        assert float(t[0]) == 0.0

    def test_inside_sphere_negative_t(self):
        """Origin inside the sphere: t0 = tca - thc < 0, returned as-is
        (and it will WIN the nearest-hit min — reference quirk)."""
        o = jnp.array([0.0, 0.0, -9.0])
        d = jnp.array([0.0, 0.0, -1.0])
        t = intersect_spheres(o, d, jnp.array([[0.0, 0.0, -10.0]]), jnp.array([2.0]))
        assert float(t[0]) < 0.0
        np.testing.assert_allclose(float(t[0]), -1.0, atol=1e-5)

    def test_tangent_and_grazing(self):
        o = jnp.array([2.0, 0.0, 0.0])
        d = jnp.array([0.0, 0.0, -1.0])
        t = intersect_spheres(o, d, jnp.array([[0.0, 0.0, -10.0]]), jnp.array([2.0]))
        np.testing.assert_allclose(float(t[0]), 10.0, atol=1e-3)

    def test_batch_shapes(self):
        o = jnp.zeros((4, 5, 3))
        d = jnp.array([0.0, 0.0, -1.0])
        c = jnp.zeros((7, 3)).at[:, 2].set(-10.0)
        t = intersect_spheres(o, d, c, jnp.ones(7))
        assert t.shape == (4, 5, 7)


class TestTriangle:
    def tri(self):
        # CCW triangle in z=-5 plane covering the origin ray
        v = np.array(
            [[[-1.0, -1.0, -5.0], [3.0, -1.0, -5.0], [-1.0, 3.0, -5.0]]], np.float32
        )
        v0 = jnp.asarray(v[:, 0])
        e1 = jnp.asarray(v[:, 1] - v[:, 0])
        e2 = jnp.asarray(v[:, 2] - v[:, 0])
        return v0, e1, e2

    def test_hit(self):
        v0, e1, e2 = self.tri()
        t, valid = intersect_tris(
            jnp.array([0.0, 0.0, 0.0]), jnp.array([0.0, 0.0, -1.0]), v0, e1, e2
        )
        assert bool(valid[0])
        np.testing.assert_allclose(float(t[0]), 5.0, atol=1e-5)

    def test_outside_uv_misses(self):
        v0, e1, e2 = self.tri()
        t, valid = intersect_tris(
            jnp.array([10.0, 10.0, 0.0]), jnp.array([0.0, 0.0, -1.0]), v0, e1, e2
        )
        assert not bool(valid[0])

    def test_parallel_ray_misses(self):
        v0, e1, e2 = self.tri()
        t, valid = intersect_tris(
            jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0]), v0, e1, e2
        )
        assert not bool(valid[0])

    def test_behind_origin_still_hits(self):
        """Möller–Trumbore as used in the reference has NO t>0 check —
        triangles behind the camera are hit with negative t
        (rayTracer.cl:74-77)."""
        v0, e1, e2 = self.tri()
        t, valid = intersect_tris(
            jnp.array([0.0, 0.0, -10.0]), jnp.array([0.0, 0.0, -1.0]), v0, e1, e2
        )
        assert bool(valid[0])
        np.testing.assert_allclose(float(t[0]), -5.0, atol=1e-5)

    def test_degenerate_zero_triangle_misses(self):
        """Zero-padded triangles (det == 0) must never hit — the packing
        invariant the Pallas kernel relies on."""
        z = jnp.zeros((1, 3))
        t, valid = intersect_tris(
            jnp.array([0.0, 0.0, 0.0]), jnp.array([0.0, 0.0, -1.0]), z, z, z
        )
        assert not bool(valid[0])


class TestNearestHit:
    def test_sphere_before_cube_strictness(self):
        """Cube processed first; sphere only wins with strictly smaller t
        (rayTracer.cl:179). At exactly equal t the cube keeps the pixel."""
        # A triangle and sphere both at distance exactly 10 along -z.
        tri = np.zeros((1, 3, 3), np.float32)
        tri[0] = [[-5, -5, -10], [5, -5, -10], [0, 10, -10]]
        scene = make_scene(
            sphere_origin=[[0.0, 0.0, -12.0]],
            sphere_radius=[2.0],
            sphere_colour=[[1.0, 0.0, 0.0, 255.0]],
            tri_verts=tri,
            tri_colour=[[0.0, 1.0, 0.0, 255.0]],
        )
        o = jnp.array([[0.0, 0.0, 0.0]])
        d = jnp.array([0.0, 0.0, -1.0])
        hit = nearest_hit(o, d, scene)
        np.testing.assert_allclose(float(hit.t[0]), 10.0, atol=1e-5)
        # tie at t=10 -> triangle (processed first) keeps it
        np.testing.assert_allclose(
            np.asarray(hit.colour[0]), [0.0, 1.0, 0.0, 255.0]
        )

    def test_sphere_wins_when_closer(self):
        tri = np.zeros((1, 3, 3), np.float32)
        tri[0] = [[-5, -5, -10], [5, -5, -10], [0, 10, -10]]
        scene = make_scene(
            sphere_origin=[[0.0, 0.0, -8.0]],
            sphere_radius=[2.0],
            sphere_colour=[[1.0, 0.0, 0.0, 255.0]],
            tri_verts=tri,
            tri_colour=[[0.0, 1.0, 0.0, 255.0]],
        )
        hit = nearest_hit(
            jnp.array([[0.0, 0.0, 0.0]]), jnp.array([0.0, 0.0, -1.0]), scene
        )
        np.testing.assert_allclose(float(hit.t[0]), 6.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(hit.colour[0]), [1, 0, 0, 255.0])

    def test_miss_gives_sentinel(self):
        scene = make_scene(
            sphere_origin=[[1000.0, 0.0, -10.0]],
            sphere_radius=[1.0],
            sphere_colour=[[1.0, 0.0, 0.0, 255.0]],
        )
        hit = nearest_hit(
            jnp.array([[0.0, 0.0, 0.0]]), jnp.array([0.0, 0.0, -1.0]), scene
        )
        assert float(hit.t[0]) == MISS_T
        assert not bool(hit.hit[0])

    def test_exact_zero_hit_discarded(self):
        """A sphere hit at exactly t=0 is treated as a miss (the 0.0-sentinel
        collision, rayTracer.cl:176-177)."""
        # Ray origin exactly on the sphere surface, pointing inward:
        # t0 = tca - thc = 0 exactly.
        scene = make_scene(
            sphere_origin=[[0.0, 0.0, -12.0]],
            sphere_radius=[2.0],
            sphere_colour=[[1.0, 0.0, 0.0, 255.0]],
        )
        hit = nearest_hit(
            jnp.array([[0.0, 0.0, -10.0]]), jnp.array([0.0, 0.0, -1.0]), scene
        )
        # t0 == 0 => "miss" per reference semantics
        assert not bool(hit.hit[0])

    def test_normals_point_against_ray(self, scene1):
        o = jnp.array([[300.0, 250.0, 0.0], [70.0, 60.0, 0.0]])
        d = jnp.array([0.0, 0.0, -1.0])
        hit = nearest_hit(o, d, scene1)
        assert bool(hit.hit[0]) and bool(hit.hit[1])
        ndotd = np.asarray(jnp.sum(hit.normal * d, axis=-1))
        assert np.all(ndotd < 0)
        # sphere normal at center ray is +z
        np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, 1], atol=1e-4)
