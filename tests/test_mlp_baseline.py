"""MLP value-baseline option (SURVEY.md section 3 "Value baseline:
linear time-feature fit or small MLP").
The linear fit stays the oracle-parity default; these tests cover the
MLP path: the refit reduces value error, full training works (improves
with the KL bound respected), the sharded update matches unsharded,
and checkpoints round-trip the pytree weights.
"""
import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from trpo_robot_control_tpu.configs import C1_REACHER2
from trpo_robot_control_tpu.models import baseline

MLP_CFG = C1_REACHER2.replace(
    n_envs=32, horizon=20,
    trpo=dataclasses.replace(C1_REACHER2.trpo, baseline="mlp",
                             baseline_hidden=(32,)))


def test_fit_mlp_reduces_mse():
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    phi = jax.random.normal(k1, (512, 10))
    y = jnp.sin(phi[:, 0]) + 0.5 * phi[:, 1] ** 2
    w = baseline.init_mlp(k2, 10, (32,))

    def mse(w):
        return float(jnp.mean((baseline.predict_mlp(w, phi) - y) ** 2))

    before = mse(w)
    w2 = jax.jit(lambda w: baseline.fit_mlp(w, phi, y, 1e-2, 50))(w)
    after = mse(w2)
    assert after < 0.5 * before, (before, after)


def test_mlp_baseline_training_improves():
    from trpo_robot_control_tpu.trpo.train import train
    state, hist = train(MLP_CFG, n_iters=10, seed=0)
    rets = [h["mean_return"] for h in hist]
    assert all(h["kl"] <= MLP_CFG.trpo.delta + 1e-6 for h in hist)
    assert np.mean(rets[-3:]) > np.mean(rets[:3]), rets


def test_mlp_baseline_sharded_equals_unsharded():
    from trpo_robot_control_tpu.envs import arm
    from trpo_robot_control_tpu.models import policy
    from trpo_robot_control_tpu.parallel.mesh import (make_mesh,
                                                      make_sharded_update,
                                                      shard_batch)
    from trpo_robot_control_tpu.trpo.train import init_state
    from trpo_robot_control_tpu.trpo.update import trpo_update
    cfg = MLP_CFG
    mesh = make_mesh(n_data=8)
    state = init_state(cfg, seed=0)
    batch = jax.jit(lambda p, k: arm.rollout(cfg, p, policy.sample, k))(
        state.params, jax.random.PRNGKey(3))
    p1, w1, _ = jax.jit(lambda p, w, b: trpo_update(cfg, p, w, b))(
        state.params, state.w, batch)
    p2, w2, _ = make_sharded_update(cfg, mesh)(
        state.params, state.w, shard_batch(mesh, batch))
    th0, _ = ravel_pytree(state.params)
    th1, _ = ravel_pytree(p1)
    th2, _ = ravel_pytree(p2)
    # CG amplifies fp32 psum reduction-order noise more here than in the
    # linear test (random-init MLP values scale the advantages up), so
    # compare the STEP direction by cosine + a loose elementwise band
    d1 = np.asarray(th1) - np.asarray(th0)
    d2 = np.asarray(th2) - np.asarray(th0)
    cos = d1 @ d2 / (np.linalg.norm(d1) * np.linalg.norm(d2) + 1e-12)
    assert cos > 0.999, cos
    np.testing.assert_allclose(np.asarray(th1), np.asarray(th2),
                               rtol=5e-2, atol=2e-3)
    wf1, _ = ravel_pytree(w1)
    wf2, _ = ravel_pytree(w2)
    np.testing.assert_allclose(np.asarray(wf1), np.asarray(wf2),
                               rtol=2e-3, atol=2e-4)


def test_mlp_baseline_checkpoint_roundtrip(tmp_path):
    from trpo_robot_control_tpu.trpo.train import init_state
    from trpo_robot_control_tpu.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
    state = init_state(MLP_CFG, seed=0)
    path = save_checkpoint(str(tmp_path), MLP_CFG, state)
    state2 = load_checkpoint(path, MLP_CFG)
    assert set(state2.w) == set(state.w)
    for k in state.w:
        np.testing.assert_array_equal(np.asarray(state.w[k]),
                                      np.asarray(state2.w[k]))
