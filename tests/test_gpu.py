"""Checks on the GPU at cell sizes: chip_smoke.py's phases (the rollout
kernel compiled for the card vs its reference, the c1 update vs the
fp64 oracle, the c5 update at default vs highest matmul precision, and
the main path). Run on a machine with a GPU:

  python -m pytest -m gpu tests/test_gpu.py

The pytest process itself is pinned to the CPU (conftest.py), so the
work runs in a child process without that pin, and the fixture decides
there whether a GPU is present; without one the tests skip.
"""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def gpu_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0 or probe.stdout.strip() != "gpu":
        pytest.skip("no GPU")
    return env


@pytest.mark.gpu
@pytest.mark.parametrize("phases", ["2,3,4", "5"])
def test_chip_smoke_phases(gpu_env, phases):
    r = subprocess.run([sys.executable, "chip_smoke.py", "--only", phases],
                       cwd=REPO, env=gpu_env, capture_output=True,
                       text=True, timeout=1800)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
