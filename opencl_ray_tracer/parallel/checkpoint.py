"""Checkpoint / resume.

The reference has none (SURVEY.md §5 — closest analogue is the optional PNG
dump). Here long inverse-rendering optimizations are real
training runs, so: orbax-backed checkpointing of the TrainState (scene +
optimizer state + step), multi-host safe (orbax handles the single-writer
coordination), plus a lightweight numpy fallback for environments without
orbax."""

from __future__ import annotations

import os
import pickle
from typing import Optional

import jax
import numpy as np

from opencl_ray_tracer.parallel.train import TrainState
from opencl_ray_tracer.utils.log import log_info, log_warning


def _to_host(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save a TrainState. Returns the checkpoint path written."""
    step = int(state.step) if step is None else step
    os.makedirs(path, exist_ok=True)
    host = _to_host(state)

    def _pickle_save(reason: str) -> str:
        log_warning("%s; using pickle fallback", reason)
        p = os.path.join(path, f"step_{step:08d}.pkl")
        with open(p, "wb") as f:
            pickle.dump(host, f)
        log_info("checkpoint saved to %s (pickle)", p)
        return p

    try:
        import orbax.checkpoint as ocp
    except ImportError as e:  # pragma: no cover - fallback path
        return _pickle_save(f"orbax unavailable ({e})")

    # orbax cannot serialize zero-size arrays (e.g. a scene with no cubes
    # has empty tri tables) — a representational limit, handled up front.
    # Any OTHER orbax save failure (half-written checkpoint, permissions)
    # propagates: silently pickling over it would mask data loss.
    if any(x.size == 0 for x in jax.tree_util.tree_leaves(host)):
        return _pickle_save("state has zero-size leaves (orbax cannot)")

    ckpt_path = os.path.join(os.path.abspath(path), f"step_{step:08d}")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(ckpt_path, host)
    log_info("checkpoint saved to %s (orbax)", ckpt_path)
    return ckpt_path


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    entries = sorted(
        e for e in os.listdir(path) if e.startswith("step_")
    )
    return os.path.join(path, entries[-1]) if entries else None


def load_checkpoint(ckpt_path: str, example_state: TrainState) -> TrainState:
    """Restore a TrainState (structure taken from `example_state`)."""
    if ckpt_path.endswith(".pkl"):
        with open(ckpt_path, "rb") as f:
            host = pickle.load(f)
        return jax.tree_util.tree_map(lambda _, v: jax.numpy.asarray(v),
                                      example_state, host)
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(
            os.path.abspath(ckpt_path), _to_host(example_state)
        )
    return jax.tree_util.tree_map(lambda v: jax.numpy.asarray(v), restored)


def resume_or_init(path: str, init_state: TrainState) -> TrainState:
    """The resume-on-restart entry: latest checkpoint if present, else init."""
    ckpt = latest_checkpoint(path)
    if ckpt is None:
        return init_state
    log_info("resuming from %s", ckpt)
    return load_checkpoint(ckpt, init_state)
