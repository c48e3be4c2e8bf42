"""Entry-point plumbing: the rollout resolver, the compile-cache path
rule, and chip_smoke.py refusing to run without a GPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from trpo_robot_control_tpu.configs import C1_REACHER2, C5_MULTITASK
from trpo_robot_control_tpu.envs.arm import (make_rollout_fn,
                                             resolve_rollout_impl)
from trpo_robot_control_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("impl,backend,want", [
    ("auto", "gpu", "pallas"),
    ("auto", "cpu", "xla"),
    ("xla", "gpu", "xla"),
    ("pallas", "cpu", "pallas"),
])
def test_resolve_rollout_impl(impl, backend, want):
    cfg = C5_MULTITASK.replace(rollout_impl=impl)
    assert resolve_rollout_impl(cfg, backend) == want


def test_termination_routes_to_scan():
    """done_dist > 0 needs in-kernel episode resampling, which the kernel
    lacks: "auto" takes the scan even on the GPU, "pallas" is refused."""
    cfg = C1_REACHER2.replace(done_dist=0.05)
    assert resolve_rollout_impl(cfg, "gpu") == "xla"
    with pytest.raises(ValueError, match="early termination"):
        resolve_rollout_impl(cfg.replace(rollout_impl="pallas"), "gpu")
    with pytest.raises(ValueError, match="rollout_impl"):
        resolve_rollout_impl(cfg.replace(rollout_impl="pallas3d"), "gpu")


def test_make_rollout_fn_interprets_kernel_on_cpu():
    """An explicit "pallas" on the CPU runs the kernel in interpret mode
    and yields the feature-first views the update's ff path reads."""
    import jax
    from trpo_robot_control_tpu.trpo.train import init_state
    cfg = C1_REACHER2.replace(n_envs=20, horizon=4, rollout_impl="pallas")
    batch = make_rollout_fn(cfg)(init_state(cfg).params,
                                 jax.random.PRNGKey(0))
    assert batch["obs_ff"].shape == (4, cfg.obs_dim, 20)
    assert batch["obs"].shape == (20, 4, cfg.obs_dim)
    assert batch["rewards_ff"].shape == (4, 20)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert path == compile_cache.cache_dir()            # no run-specific part
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """On the CPU, and from a directory holding chip_smoke.py and nothing
    else of the repo, the smoke test exits non-zero and never reports
    success."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    r = _smoke(cwd)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
