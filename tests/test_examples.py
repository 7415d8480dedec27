"""Smoke-run the examples/ scripts at tiny sizes (
untested examples are one refactor from silently breaking). Each runs in a
forced-CPU subprocess exactly as the example's own docstring prescribes."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=1800):  # generous: 2 shared cores
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    flags.append("--xla_force_host_platform_device_count=2")
    env["XLA_FLAGS"] = " ".join(flags)
    return subprocess.run(
        [sys.executable, os.path.join("examples", script), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_flythrough_demo_smoke(tmp_path):
    proc = _run(
        "flythrough_demo.py",
        "--frames", "2", "--width", "256", "--height", "128",
        "--png-prefix", str(tmp_path / "fly"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fps" in proc.stdout
    assert os.path.exists(str(tmp_path / "fly") + "000.png")


def test_inverse_rendering_demo_smoke(tmp_path):
    proc = _run(
        "inverse_rendering_demo.py",
        "--width", "128", "--height", "64", "--steps", "3",
        "--out-prefix", str(tmp_path / "inv"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(str(tmp_path / "inv") + "_target.png")
