"""Multi-process correctness (SURVEY.md sections 6.4/7): two CPU processes x 4 fake devices each, joined by
`jax.distributed` through parallel/mesh.py:init_distributed into ONE
8-device global mesh, must produce the same sharded training result as
a single process with 8 fake devices. The cross-process psum here is
the only cross-host evidence obtainable without multi-host hardware.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.configs import C1_REACHER2
from trpo_robot_control_tpu.parallel.mesh import (make_mesh,
                                                  make_sharded_train_step)
from trpo_robot_control_tpu.trpo.train import init_state

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_psum_equals_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "dist.npz"
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_dist_worker.py"),
             str(out)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    dist = np.load(out)

    # same run, single process, 8 fake devices (this pytest process)
    cfg = C1_REACHER2.replace(n_envs=32, horizon=20)
    mesh = make_mesh(n_data=8)
    state = init_state(cfg, seed=0)
    step = make_sharded_train_step(cfg, mesh, donate=False)
    state, stats = step(state)
    theta, _ = ravel_pytree(jax.device_get(state.params))

    # same devices, same shard layout, same math; only the psum transport
    # differs (in-process XLA all-reduce vs cross-process collective),
    # whose fp32 reduction order CG amplifies — same tolerance as
    # test_sharding.py's sharded-vs-unsharded single update
    np.testing.assert_allclose(dist["theta"], np.asarray(theta),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(dist["mean_return"]),
                               float(stats["mean_return"]), rtol=1e-4)
    assert int(dist["accepted"]) == int(stats["accepted"])


@pytest.mark.slow
def test_absent_peer_surfaces_actionable_error():
    """SURVEY.md section 7 failure-detection row: a multi-host job whose
    peer never arrives must fail with a one-line actionable error naming
    the layout within the bounded timeout — not hang until the scheduler
    kills it. One process claims a 2-process layout; no peer is started."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
               JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="0",
               JAX_DIST_INIT_TIMEOUT="10")
    code = (
        "import os, sys\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "sys.path.insert(0, '.')\n"
        "from trpo_robot_control_tpu.parallel.mesh import init_distributed\n"
        "init_distributed()\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "multi-host barrier failed" in p.stderr, p.stderr[-2000:]
    assert "process 0/2" in p.stderr, p.stderr[-2000:]
    assert f"localhost:{port}" in p.stderr, p.stderr[-2000:]
