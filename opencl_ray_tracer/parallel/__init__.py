from opencl_ray_tracer.parallel.mesh import (
    HOST_AXIS,
    IMAGE_AXIS,
    make_mesh,
    make_mesh_2d,
    mesh_from_config,
    mesh_n_shards,
    mesh_row_axes,
    render_sharded,
    replicate,
    shard_rows,
    shift_camera_rows,
)
from opencl_ray_tracer.parallel.train import (
    TrainState,
    init_train_state,
    make_train_step,
)
from opencl_ray_tracer.parallel import distributed

__all__ = [
    "HOST_AXIS",
    "IMAGE_AXIS",
    "make_mesh",
    "make_mesh_2d",
    "mesh_from_config",
    "mesh_n_shards",
    "mesh_row_axes",
    "render_sharded",
    "replicate",
    "shard_rows",
    "shift_camera_rows",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "distributed",
]
