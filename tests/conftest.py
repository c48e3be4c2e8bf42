"""Force an 8-device CPU mesh for all tests (SURVEY.md section 6.4).

Must run before jax is imported anywhere, hence env vars are set at
conftest import time. Tests that need the GPU (marker `gpu`,
tests/test_gpu.py) run their work in a child process with the CPU
pin removed.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
