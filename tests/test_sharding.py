"""Distribution correctness on the fake 8-device CPU mesh (SURVEY.md
section 6.4): the shard_map update on a sharded batch must equal the
single-device update on the full batch, and the sharded train step must
run and improve return.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.configs import C1_REACHER2
from trpo_robot_control_tpu.envs import arm
from trpo_robot_control_tpu.models import policy
from trpo_robot_control_tpu.parallel.mesh import (make_mesh,
                                                  make_sharded_train_step,
                                                  make_sharded_update,
                                                  shard_batch)
from trpo_robot_control_tpu.trpo.train import init_state
from trpo_robot_control_tpu.trpo.update import trpo_update

CFG = C1_REACHER2.replace(n_envs=32, horizon=20)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest should fake 8 CPU devices"
    return make_mesh(n_data=8)


def _collect(seed=0):
    state = init_state(CFG, seed)
    batch = jax.jit(lambda p, k: arm.rollout(CFG, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(42))
    return state, batch


def test_sharded_update_equals_unsharded(mesh8):
    state, batch = _collect()
    p1, w1, st1 = jax.jit(lambda p, w, b: trpo_update(CFG, p, w, b))(
        state.params, state.w, batch)

    sharded = make_sharded_update(CFG, mesh8)
    p2, w2, st2 = sharded(state.params, state.w, shard_batch(mesh8, batch))

    th1, _ = ravel_pytree(p1)
    th2, _ = ravel_pytree(p2)
    # reduction order differs across shards -> fp32 tolerance, not bitwise
    np.testing.assert_allclose(np.asarray(th1), np.asarray(th2),
                               rtol=2e-3, atol=2e-4)
    assert int(st1["accepted"]) == int(st2["accepted"])
    np.testing.assert_allclose(float(st1["beta"]), float(st2["beta"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(st1["kl"]), float(st2["kl"]),
                               rtol=5e-3, atol=1e-5)
    # baseline weights compared in prediction space (near-null-space
    # freedom under the small ridge at fp32; same as test_parity.py)
    from trpo_robot_control_tpu.models import baseline
    phi = np.asarray(baseline.features(batch["obs"], CFG.horizon))
    v1 = phi @ np.asarray(w1)
    v2 = phi @ np.asarray(w2)
    scale = np.abs(v1).mean() + 1e-6
    assert np.abs(v1 - v2).max() / scale < 2e-2


def test_sharded_train_step_pallas_rollout_runs(mesh8):
    """The fused rollout kernel executes inside the sharded train step
    (interpret on CPU; each shard rolls out its own 4-env slice, padded
    to the kernel's tile). The kernel draws its action noise in bulk,
    so its stream differs from the XLA path's: this checks execution and
    the update on the kernel's feature-first batch, not bitwise
    equality (tests/test_pallas_rollout*.py cover the kernel)."""
    cfg = CFG.replace(n_envs=32, horizon=8, rollout_impl="pallas")
    step = make_sharded_train_step(cfg, mesh8, donate=False)
    state = init_state(cfg, seed=0)
    state, stats = step(state)
    assert int(state.iteration) == 1
    assert np.isfinite(float(stats["mean_return"]))
    assert float(stats["kl"]) <= cfg.trpo.delta + 1e-6


def test_sharded_train_step_improves(mesh8):
    step = make_sharded_train_step(CFG, mesh8, donate=False)
    state = init_state(CFG, seed=0)
    returns = []
    for _ in range(8):
        state, stats = step(state)
        returns.append(float(stats["mean_return"]))
        assert float(stats["kl"]) <= CFG.trpo.delta + 1e-6
    assert np.mean(returns[-3:]) > np.mean(returns[:3]), returns


def test_mesh_axis_sizes(mesh8):
    assert mesh8.shape["data"] == 8
    assert mesh8.axis_names == ("data",)


def test_uneven_envs_rejected(mesh8):
    with pytest.raises(ValueError):
        make_sharded_train_step(CFG.replace(n_envs=30), mesh8)


def test_sharded_update_env_subsample_equals_unsharded(mesh8):
    """fvp_env_subsample's strided env set is sharding-invariant when
    local N % k == 0 (round 5): per-shard [::k] unions to the global
    [::k] set and the equal-count pmean of per-shard Fisher means
    equals the global mean, so the env-strided update must match the
    unsharded one within the usual reduction-order tolerance."""
    import dataclasses
    cfg = CFG.replace(trpo=dataclasses.replace(CFG.trpo,
                                               fvp_env_subsample=2))
    state, batch = _collect()
    p1, _, st1 = jax.jit(lambda p, w, b: trpo_update(cfg, p, w, b))(
        state.params, state.w, batch)

    sharded = make_sharded_update(cfg, mesh8)
    p2, _, st2 = sharded(state.params, state.w, shard_batch(mesh8, batch))

    th1, _ = ravel_pytree(p1)
    th2, _ = ravel_pytree(p2)
    np.testing.assert_allclose(np.asarray(th1), np.asarray(th2),
                               rtol=2e-3, atol=2e-4)
    assert int(st1["accepted"]) == int(st2["accepted"])
    np.testing.assert_allclose(float(st1["beta"]), float(st2["beta"]),
                               rtol=2e-3)
