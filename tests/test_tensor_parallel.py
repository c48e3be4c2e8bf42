"""Tensor parallelism over the 'model' mesh axis (SURVEY.md section 3
parallelism table; parallel/tensor.py): the TP-sharded update must equal
the plain single-device update on the same batch, at every mesh shape
that fits 8 fake devices, and the TP train step must actually train.
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
                                                  make_sharded_update_tp,
                                                  shard_batch)
from trpo_robot_control_tpu.trpo.train import init_state
from trpo_robot_control_tpu.trpo.update import trpo_update

CFG = C1_REACHER2.replace(n_envs=32, horizon=20)


def _collect(seed=0):
    state = init_state(CFG, seed)
    batch = jax.jit(lambda p, k: arm.rollout(CFG, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(42))
    return state, batch


def test_tp_forward_equals_replicated():
    """mean_net_tp under shard_map == plain mean_net."""
    from jax.sharding import PartitionSpec as P
    from trpo_robot_control_tpu.parallel import tensor
    state, batch = _collect()
    obs = batch["obs"].reshape(-1, CFG.obs_dim)
    mu_ref = np.asarray(policy.mean_net(state.params, obs))
    mesh = make_mesh(n_data=4, n_model=2)

    def fwd(params, obs):
        idx = jax.lax.axis_index("model")
        local = tensor.shard_policy_params(params, 2, idx)
        return tensor.mean_net_tp(local, obs, "model")

    mu_tp = jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data"),
        check_vma=False))(state.params, obs)
    np.testing.assert_allclose(np.asarray(mu_tp), mu_ref,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4), (1, 8)])
def test_tp_update_equals_unsharded(n_data, n_model):
    state, batch = _collect()
    p1, w1, st1 = jax.jit(lambda p, w, b: trpo_update(CFG, p, w, b))(
        state.params, state.w, batch)

    mesh = make_mesh(n_data=n_data, n_model=n_model)
    tp = make_sharded_update_tp(CFG, mesh)
    p2, w2, st2 = tp(state.params, state.w, shard_batch(mesh, batch))

    th1, _ = ravel_pytree(p1)
    th2, _ = ravel_pytree(p2)
    np.testing.assert_allclose(np.asarray(th1), np.asarray(th2),
                               rtol=2e-3, atol=2e-4)
    assert int(st1["accepted"]) == int(st2["accepted"])
    np.testing.assert_allclose(float(st1["beta"]), float(st2["beta"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(st1["kl"]), float(st2["kl"]),
                               rtol=5e-3, atol=1e-5)


def test_tp_update_equals_unsharded_mlp_baseline():
    """TP + the MLP value baseline. The baseline is batch-space — replicated
    across 'model', Adam-refit with 'data'-reduced gradients — so the TP
    update must still equal the plain update."""
    import dataclasses
    cfg = CFG.replace(trpo=dataclasses.replace(CFG.trpo, baseline="mlp",
                                               baseline_epochs=3))
    state = init_state(cfg, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(cfg, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(42))
    p1, w1, st1 = jax.jit(lambda p, w, b: trpo_update(cfg, p, w, b))(
        state.params, state.w, batch)
    mesh = make_mesh(n_data=4, n_model=2)
    tp = make_sharded_update_tp(cfg, mesh)
    p2, w2, st2 = tp(state.params, state.w, shard_batch(mesh, batch))
    th1, _ = ravel_pytree(p1)
    th2, _ = ravel_pytree(p2)
    np.testing.assert_allclose(np.asarray(th1), np.asarray(th2),
                               rtol=2e-3, atol=2e-4)
    v1, _ = ravel_pytree(w1)
    v2, _ = ravel_pytree(w2)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(st1["beta"]), float(st2["beta"]),
                               rtol=2e-3)


def test_tp_train_step_fused_rollout_interpret():
    """The TP train step collects with the same rollout resolver as the
    DP path. Force the fused rollout kernel (interpret mode) under the
    TP shard_map and check the step trains; 40 envs / 4 data shards =
    10 local envs, padded to the kernel's 16-env tile."""
    cfg = CFG.replace(n_envs=40, horizon=10, rollout_impl="pallas")
    mesh = make_mesh(n_data=4, n_model=2)
    step = make_sharded_train_step(cfg, mesh, donate=False)
    state = init_state(cfg, seed=0)
    for _ in range(2):
        state, stats = step(state)
        assert np.isfinite(float(stats["mean_return"]))
        assert float(stats["kl"]) <= cfg.trpo.delta + 1e-6
    assert int(state.iteration) == 2


def test_tp_train_step_improves():
    mesh = make_mesh(n_data=4, n_model=2)
    step = make_sharded_train_step(CFG, mesh, donate=False)
    state = init_state(CFG, seed=0)
    returns = []
    for _ in range(8):
        state, stats = step(state)
        returns.append(float(stats["mean_return"]))
        assert float(stats["kl"]) <= CFG.trpo.delta + 1e-6
    # params stay full/replicated (all-gathered after the TP update)
    assert state.params["W0"].shape == (CFG.obs_dim,
                                        CFG.trpo.hidden[0])
    assert np.mean(returns[-3:]) > np.mean(returns[:3]), returns
