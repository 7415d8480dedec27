"""Test configuration: a virtual 8-device CPU mesh, and the `gpu` marker.

This is the "fake backend" strategy from SURVEY.md §4: sharding code paths
exercise a real Mesh without several accelerators, and the Pallas kernels
run in the Pallas interpreter — every kernel test passes interpret=True
(or RenderConfig(interpret=True)) itself; nothing infers it.

Tests marked `gpu` run the compiled kernels and need the card. They take
the `gpu` fixture, which skips them when JAX has no GPU. On the card:

    python -m pytest -m gpu tests/
"""

import os

# Read at CPU-backend init: gives the mesh tests 8 virtual CPU devices.
# Has no effect on a GPU backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with -m gpu on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs


@pytest.fixture(scope="session")
def scene1():
    from opencl_ray_tracer import create_scene1

    return create_scene1()


@pytest.fixture(scope="session")
def scene2():
    from opencl_ray_tracer import create_scene2

    return create_scene2(seed=7)


@pytest.fixture(scope="session")
def scene3_small():
    """Scene-3-style stress scene at reduced count for CI speed."""
    from opencl_ray_tracer import random_scene

    return random_scene(20, 20, seed=3)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
