"""Scene model tests: cube baking fidelity, SoA layout, packing invariants."""

import numpy as np
import pytest

from opencl_ray_tracer import Cube, create_scene, create_scene1
from opencl_ray_tracer.scene import (
    TRIS_PER_CUBE,
    UNIT_CUBE_VERTS,
    bake_cube_params,
    random_scene,
)


class TestCube:
    def test_unit_cube_has_36_verts_in_pm1(self):
        assert UNIT_CUBE_VERTS.shape == (36, 3)
        assert set(np.unique(UNIT_CUBE_VERTS)) == {-1.0, 1.0}

    def test_unit_cube_faces_closed(self):
        """All 12 triangles have area 2 (unit cube face = 2 triangles of
        area 2 each for the +-1 cube) and lie on a cube face."""
        tris = UNIT_CUBE_VERTS.reshape(12, 3, 3)
        e1 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        np.testing.assert_allclose(areas, 2.0, rtol=1e-6)
        # each triangle has one constant +-1 coordinate (its face plane)
        for t in tris:
            const_axis = [
                a for a in range(3) if np.all(t[:, a] == t[0, a]) and abs(t[0, a]) == 1
            ]
            assert len(const_axis) == 1

    def test_scale_translate(self):
        c = Cube([1, 0, 0, 255.0])
        c.scale(2.0).translate((10.0, 0.0, 0.0))
        v = c.vertices
        assert v[:, 0].min() == 8.0 and v[:, 0].max() == 12.0
        assert v[:, 1].min() == -2.0 and v[:, 1].max() == 2.0

    def test_rotate_z90(self):
        c = Cube([1, 0, 0, 255.0])
        c.rotate((0.0, 0.0, np.pi / 2))
        # Rz(90): (x, y, z) -> (-y, x, z)
        expect = np.stack(
            [-UNIT_CUBE_VERTS[:, 1], UNIT_CUBE_VERTS[:, 0], UNIT_CUBE_VERTS[:, 2]],
            axis=-1,
        )
        np.testing.assert_allclose(c.vertices, expect, atol=1e-6)

    def test_rotation_order_zyx(self):
        """rotate((rx, ry, rz)) must apply Rz @ Ry @ Rx (Cube.cpp:53-63)."""
        rx, ry, rz = 0.3, -0.7, 1.1

        def rot_x(a):
            c, s = np.cos(a), np.sin(a)
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

        def rot_y(a):
            c, s = np.cos(a), np.sin(a)
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

        def rot_z(a):
            c, s = np.cos(a), np.sin(a)
            return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

        m = rot_z(rz) @ rot_y(ry) @ rot_x(rx)
        c = Cube([0, 0, 0, 255.0])
        c.rotate((rx, ry, rz))
        np.testing.assert_allclose(c.vertices, UNIT_CUBE_VERTS @ m.T, atol=1e-5)

    def test_bake_cube_params_matches_builder(self):
        """Differentiable bake == host builder for single-rotate chains."""
        center, scale, euler = (5.0, -3.0, 2.0), (2.0, 3.0, 4.0), (0.3, -0.7, 1.1)
        c = Cube([0, 0, 0, 255.0])
        c.scale(scale).rotate(euler).translate(center)
        baked = np.asarray(
            bake_cube_params(
                np.float32(center), np.float32(scale), np.float32(euler)
            )
        ).reshape(36, 3)
        np.testing.assert_allclose(baked, c.vertices, atol=1e-4)


class TestSceneLibrary:
    def test_scene1_inventory(self, scene1):
        """Scene 1: 2 spheres + 4 cubes (MainState.cpp:419-462)."""
        assert scene1.num_spheres == 2
        assert scene1.num_cubes == 4
        assert scene1.num_triangles == 48
        np.testing.assert_allclose(
            np.asarray(scene1.sphere_origin),
            [[300.0, 250.0, -85.0], [500.0, 250.0, -85.0]],
        )
        np.testing.assert_allclose(np.asarray(scene1.sphere_radius), [50.0, 30.0])

    def test_scene2_inventory(self, scene2):
        assert scene2.num_spheres == 8
        assert scene2.num_cubes == 10

    def test_scene3_inventory(self):
        s = create_scene(3, seed=0)
        assert s.num_spheres == 100
        assert s.num_cubes == 100

    def test_scene_determinism(self):
        a = create_scene(2, seed=42)
        b = create_scene(2, seed=42)
        np.testing.assert_array_equal(
            np.asarray(a.tri_verts), np.asarray(b.tri_verts)
        )
        np.testing.assert_array_equal(
            np.asarray(a.sphere_colour), np.asarray(b.sphere_colour)
        )
        c = create_scene(2, seed=43)
        assert not np.array_equal(
            np.asarray(a.sphere_colour), np.asarray(c.sphere_colour)
        )

    def test_random_scene_bounds(self):
        s = random_scene(50, 10, seed=1)
        so = np.asarray(s.sphere_origin)
        assert so[:, 0].min() >= 0 and so[:, 0].max() <= 630
        assert so[:, 2].max() <= -20 and so[:, 2].min() >= -100
        r = np.asarray(s.sphere_radius)
        assert r.min() >= 5 and r.max() <= 30


class TestPacking:
    def test_packed_layout(self, scene1):
        p = scene1.pack()
        assert p.sph_origin.shape == (3, 128)
        assert p.tri_v0.shape == (3, 128)
        assert p.n_spheres == 2 and p.n_tris == 48
        # padding spheres sit far away with radius 0
        so = np.asarray(p.sph_origin)
        assert so[2, 3] == 1e9
        assert np.asarray(p.sph_radius)[0, 3] == 0.0
        # padded triangles are degenerate (zero edges)
        np.testing.assert_array_equal(np.asarray(p.tri_e1)[:, 48:], 0.0)

    def test_pack_preserves_data(self, scene2):
        p = scene2.pack()
        np.testing.assert_allclose(
            np.asarray(p.sph_origin)[:, :8].T, np.asarray(scene2.sphere_origin)
        )
        v0 = np.asarray(scene2.tri_verts)[:, 0, :]
        np.testing.assert_allclose(np.asarray(p.tri_v0)[:, :120].T, v0)

    def test_pack_is_differentiable(self, scene1):
        import jax
        import jax.numpy as jnp

        def loss(radius):
            s2 = jax.tree_util.tree_map(lambda x: x, scene1)
            s2.sphere_radius = radius
            return jnp.sum(s2.pack().sph_radius)

        g = jax.grad(loss)(scene1.sphere_radius)
        np.testing.assert_allclose(np.asarray(g), [1.0, 1.0])
