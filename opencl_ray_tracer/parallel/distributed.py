"""Multi-process bring-up.

The reference has no distributed story (one process, one device). Here the
multi-process path is jax.distributed: every process runs the same program,
the mesh spans all processes' devices, row shards land on local devices,
and the scene-grad psum crosses processes.

On a single host this module is a no-op; `initialize()` is safe to call
unconditionally from the CLI/bench entry points.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from opencl_ray_tracer.utils.log import log_info


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed when running multi-process.

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); single-process runs return
    immediately.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 or coordinator_address is None:
        return
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0"))
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log_info(
        "jax.distributed initialized: process %d/%d, %d global devices",
        process_id,
        num_processes,
        len(jax.devices()),
    )


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_row_block(height: int) -> tuple:
    """(row0, rows) owned by this process under row sharding."""
    n = jax.process_count()
    assert height % n == 0
    rows = height // n
    return jax.process_index() * rows, rows
