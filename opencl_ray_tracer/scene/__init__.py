from opencl_ray_tracer.scene.cube import (
    Cube,
    UNIT_CUBE_VERTS,
    TRIS_PER_CUBE,
    bake_cube_params,
    cubes_to_triangles,
)
from opencl_ray_tracer.scene.scene import Lights, PackedScene, Scene
from opencl_ray_tracer.scene.library import (
    create_scene,
    create_scene1,
    create_scene2,
    create_scene3,
    random_scene,
)

__all__ = [
    "Cube",
    "UNIT_CUBE_VERTS",
    "TRIS_PER_CUBE",
    "bake_cube_params",
    "cubes_to_triangles",
    "Lights",
    "PackedScene",
    "Scene",
    "create_scene",
    "create_scene1",
    "create_scene2",
    "create_scene3",
    "random_scene",
]
